"""Development probe of K2 (attention backward) on one CUDA card.

    python -m dmtpu_torch.dev.k2_probe            # check, time, variants, d256, d512, fresh
    python -m dmtpu_torch.dev.k2_probe variants   # one phase

- ``check``: builds the kernels, prints what ``ptxas`` said of the wgmma
  kernel (registers, spills, any C75xx remark), and holds the wgmma kernel
  against K2's plain version at small, ragged and full-width shapes.
- ``time``: both K2 kernels in the order mma, wgmma, wgmma, mma, beside the
  backward of ``scaled_dot_product_attention`` (forward and backward less the
  forward alone), b16 h8 bf16, and the wgmma path's three kernels apart
  (``torch.profiler``).
- ``variants``: what each kernel's time is made of, at SD1.5's S=4096 d=40,
  S=1024 d=80 and S=256 d=160 and the CIFAR UNet's b128 S=256 d=256.
  Patched copies of the two sources are built beside each other
  (``build/dev/variants/``) and timed in turns: the mma.sync kernel with its dQ atomics compiled out, with its
  exponentials replaced by a multiply, and with both; the wgmma kernel without
  its bulk reduce-adds, without its exponentials, and without both.  The
  patched kernels compute wrong values; only their times are read.
- ``d256``: the mma.sync kernel's head-dim-256 instance with each 64-row
  step walked in sub-steps of 16 rows (as built) and of 32, built from
  patched copies side by side: what ``ptxas`` says of each (registers,
  spills), both against K2's plain version, and their times in turns at the
  pixel UNets' shapes (b128 h1 S=256 and S=16, a ragged S=200, d=248),
  beside SDPA's backward in this fresh process.
- ``d512``: the head-dim-512 instances, the wgmma pair
  (``flash_bwd_pair_kernel`` in ``csrc/flash_attn_bwd.cu``) and mma.sync's
  (``csrc/flash_attn_bwd_mma_d512.cu``): what ``ptxas`` says of them
  (registers, spills, shared memory), both against K2's plain version at
  CelebA-HQ's shapes (b16 h1 S=256 and S=64), ragged lengths, padded head
  dims (504, 384, 264), a strided dO and b128 S=256, the pair's bits twice
  where one key tile holds every key, and both in turns by CUDA events and
  alone by device time (``torch.profiler``), beside SDPA's backward by
  device time (its backend named) and the bound.
- ``fresh``: both kernels at the shapes of the column-split instances'
  paths (SD1.5's four d=160 shapes at b16 h8; the CIFAR UNet's d=256 at
  b128 h1 S=256 and S=16, a ragged b8 S=200 and d=248), against K2's plain
  version, in turns (mma, wgmma, wgmma, mma) by CUDA events over 20 calls
  and alone by device time (``torch.profiler``), beside SDPA's backward
  (forward and backward less the forward, by events and by device time,
  its backend named) and the bound, and the wgmma call's device time by
  kernel (first pass, main kernel, cast), in a process that has run nothing else
  (late in ``chip_smoke.py`` SDPA's backward reads several times slower
  than here).

With no argument each phase runs in a process of its own with a time limit: a
kernel that hangs on an mbarrier would otherwise never return.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "dmtpu_torch" / "csrc"
OUT = ROOT / "build" / "dev" / "variants"
PHASE_LIMITS = {"check": 240, "time": 300, "variants": 300, "d256": 180,
                "d512": 180, "fresh": 120}  # seconds

CHECK_SHAPES = [  # b, sq, sk, h, d
    (1, 64, 128, 1, 40), (1, 128, 256, 1, 40), (2, 256, 512, 2, 40), (1, 64, 128, 1, 80),
    (2, 256, 512, 2, 80), (2, 333, 200, 3, 40), (2, 200, 333, 3, 80), (1, 1, 130, 1, 40),
    (2, 100, 77, 2, 80), (2, 333, 128, 3, 40), (2, 4096, 77, 8, 40), (2, 1024, 77, 8, 80),
    (2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (1, 64, 128, 1, 72), (2, 200, 333, 3, 72),
    (2, 100, 77, 2, 72), (4, 256, 256, 16, 72), (1, 64, 128, 1, 64), (2, 333, 333, 3, 64),
    (2, 100, 77, 2, 64), (2, 4250, 4250, 2, 64), (8, 333, 333, 12, 64),
    # the column-split instances: SD1.5's d=160 shapes (b2 h8), the pixel
    # UNets' d=256 (b8 h1), ragged lengths, padded head dims on both (96 and
    # 152 on 160, 168 and 248 on 256), one row, one key tile
    (2, 256, 256, 8, 160), (2, 64, 64, 8, 160), (2, 256, 77, 8, 160), (2, 64, 77, 8, 160),
    (2, 200, 333, 3, 152), (2, 333, 200, 2, 160), (1, 1, 130, 1, 96), (2, 100, 50, 2, 160),
    (8, 256, 256, 1, 256), (8, 16, 16, 1, 256), (8, 200, 200, 1, 256), (4, 256, 256, 1, 248),
    (2, 77, 333, 2, 256), (2, 333, 40, 1, 168), (1, 64, 64, 1, 256), (128, 256, 256, 1, 256)]
# DiT-XL/2's self-attention: q, k and v strided views of one [B, S, 3, H, D]
# projection (b, s, h, d)
STRIDED_SHAPES = [(4, 256, 16, 72), (32, 256, 16, 72), (4, 256, 2, 160), (4, 256, 1, 256)]
TIMED_SHAPES = [(4096, 4096, 40), (1024, 1024, 80), (4096, 77, 40), (1024, 77, 80),
                (256, 256, 40), (4096, 256, 40), (256, 256, 72), (333, 333, 64),
                (4250, 4250, 64)]  # sq, sk, d at b16 h8

# (source file, entry point, {variant: [(pattern, replacement), ...]}); a
# pattern is a regular expression that must match the source
_NO_ATOMICS = (r"atomicAdd\(dst, acc\[n\]\[2 \* r\]\);\s*atomicAdd\(dst \+ 1, [^;]*;",
               "if (acc[n][2 * r] == 12345.678f && acc[n][2 * r + 1] == 2.5f) dst[0] = 1.f;")
_MMA_NO_EXP = (r"exp2f\((s\[j\]\[c\] \* scale_log2 - tL\[r\])\)", r"(\1)")
_NO_REDUCE = (r"bulk_reduce_add_f32\(dq_out[^;]*;", "")
_WGMMA_NO_EXP = (r"ex2\((fmaf\(s\[[^\]]*\], scale_log2, -l\.[xy]\))\)", r"\1")
VARIANTS = [
    ("flash_attn_bwd_mma.cu", "dmtpu_flash_attn_bwd_mma",
     {"as_it_is": [], "no_dq_atomics": [_NO_ATOMICS], "no_exp": [_MMA_NO_EXP],
      "neither": [_NO_ATOMICS, _MMA_NO_EXP]}),
    ("flash_attn_bwd.cu", "dmtpu_flash_attn_bwd",
     {"as_it_is": [], "no_dq_reduce": [_NO_REDUCE], "no_exp": [_WGMMA_NO_EXP],
      "neither": [_NO_REDUCE, _WGMMA_NO_EXP]}),
]


def patched(source: str, substitutions, flags: int = 0) -> str:
    """``source`` with every (pattern, replacement) applied; a pattern that
    matches nothing raises, so an edited kernel cannot silently go unpatched."""
    for pattern, replacement in substitutions:
        source, n = re.subn(pattern, replacement, source, flags=flags)
        if n == 0:
            raise ValueError(f"pattern matches nothing: {pattern}")
    return source


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip()


def _time_ms(torch, fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn, reps: int = 20) -> float:
    """The card's time of one call of ``fn``: the device time of every kernel
    it launched (``torch.profiler``), over ``reps`` calls.  Unlike CUDA events
    around the calls this leaves out the host's time between launches, which
    at small shapes is the larger."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def sdpa_backend(torch, q, k, v) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for [B, H, S, D]
    q, k, v ("unknown" where this PyTorch has no choice function)."""
    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "unknown"
    from torch.nn.attention import SDPBackend
    return SDPBackend(choose(q, k, v)).name


def _case(torch, gen, b, sq, sk, h, d):
    return [torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
            for s in (sq, sk, sk, sq)]


def _strided_case(torch, gen, b, s, h, d):
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").bfloat16()
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do


def check() -> int:
    import torch
    from dmtpu_torch.ops import _build
    from dmtpu_torch.ops.flash_attention import (flash_attention_backward_reference,
                                                 flash_attention_bwd, flash_attention_reference,
                                                 wgmma_bwd_key_tile)
    t0 = time.time()
    lib = _build.build()
    _build.library()
    print(f"built and loaded in {time.time() - t0:.1f} s", flush=True)
    log = (lib.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "C75" in line or "error" in line.lower():
            print("  ", line.strip()[:300])
        if re.search("flash_bwd_(wgmma|split)_kernel", line) and "Compiling" in line:
            print("  ", "\n   ".join(x.strip()[:160] for x in log[i:i + 5]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    cases = [(shape, False) for shape in CHECK_SHAPES]
    cases += [((b, s, s, h, d), True) for b, s, h, d in STRIDED_SHAPES]
    for (b, sq, sk, h, d), strided in cases:
        q, k, v, do = (_strided_case(torch, gen, b, sq, h, d) if strided
                       else _case(torch, gen, b, sq, sk, h, d))
        o, lse = flash_attention_reference(q, k, v)
        want = flash_attention_backward_reference(q, k, v, o, lse, do)
        got = flash_attention_bwd(q, k, v, o, lse, do, kernel="wgmma")
        torch.cuda.synchronize()
        line = f"wgmma b{b} sq{sq} sk{sk} h{h} d{d}{' strided' if strided else ''}:"
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            a, w = a.float(), w.float()
            err, rel = (a - w).abs().max().item(), ((a - w).norm() / w.norm()).item()
            ok = err <= 1e-2 * w.abs().max().item() and rel <= 1e-2 and \
                bool(torch.isfinite(a).all())
            bad += not ok
            line += f" {name} max err {err:.2e} rel L2 {rel:.2e} {'ok' if ok else 'BAD'};"
            if not ok:  # where it is wrong: by block of 16 rows, and by column
                diff = (a - w).abs()[0, :, 0]
                rows = diff.amax(-1)[:diff.shape[0] // 16 * 16].reshape(-1, 16).amax(-1)
                print("   ", name, "rows:", [round(x, 3) for x in rows[:16].tolist()],
                      "columns:", [round(x, 3) for x in diff.amax(0).tolist()])
        if sk <= wgmma_bwd_key_tile(d):
            again = flash_attention_bwd(q, k, v, o, lse, do, kernel="wgmma")
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            bad += not same
            line += f" same bits again: {same}"
        print(line, flush=True)
    print("check:", "FAILED" if bad else "all ok")
    return 1 if bad else 0


def _sdpa_backward_ms(torch, q, k, v, do, device: bool = False) -> float:
    """SDPA's backward: forward and backward of one call on [B, H, S, D]
    views less the forward alone, by CUDA events or (``device``) by device
    time."""
    lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    ldo = do.transpose(1, 2)

    def fwd_bwd():
        out = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)
        lq.grad = lk.grad = lv.grad = None
        out.backward(ldo)

    def fwd():
        with torch.no_grad():
            torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)

    clock = _device_ms if device else _time_ms
    return clock(torch, fwd_bwd) - clock(torch, fwd)


def timing() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd
    print(_card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for sq, sk, d in TIMED_SHAPES:
        q, k, v, do = _case(torch, gen, 16, sq, sk, 8, d)
        o, lse = flash_attention_fwd(q, k, v)
        row = {}
        for name in ("mma", "wgmma", "wgmma", "mma"):
            row.setdefault(name, []).append(round(_time_ms(
                torch, lambda: flash_attention_bwd(q, k, v, o, lse, do, kernel=name)), 4))
        row["sdpa_backward"] = round(_sdpa_backward_ms(torch, q, k, v, do), 4)
        print("K2 b16 h8 ms", (sq, sk, d), row, flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                flash_attention_bwd(q, k, v, o, lse, do, kernel="wgmma")
            torch.cuda.synchronize()
        for event in prof.key_averages():
            if "flash" in event.key:
                print("    ", event.key[:72], round(event.self_device_time_total / 5e3, 4), "ms")
    return 0


# b, h, sq, sk, d: SD1.5's two long self-attentions, its d=160 S=256 and the
# CIFAR UNet's b128 d=256 S=256 (the column-split instances)
VARIANT_SHAPES = [(16, 8, 4096, 4096, 40), (16, 8, 1024, 1024, 80), (16, 8, 256, 256, 160),
                  (128, 1, 256, 256, 256)]


def variants() -> int:
    import torch
    from dmtpu_torch.ops.flash_attention import _BWD_ROWS, flash_attention_fwd
    entries = {}
    built = _build_variants([(f"{Path(source).stem}.{name}", source, entry, subs)
                             for source, entry, named in VARIANTS
                             for name, subs in named.items()])
    for source, _, named in VARIANTS:
        entries[source] = {name: built[f"{Path(source).stem}.{name}"][0] for name in named}
    print(_card())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, sq, sk, d in VARIANT_SHAPES:
        q, k, v, do = _case(torch, gen, b, sq, sk, h, d)
        o, lse = flash_attention_fwd(q, k, v)
        rows = b * h * -(-sq // _BWD_ROWS[d]) * _BWD_ROWS[d]  # enough for either kernel
        scratch = torch.empty(2 * rows + rows * d, device="cuda")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        strides = [x for t in (q, k, v, o, do, dk, dv) for x in t.stride()[:3]]
        for source, named in entries.items():
            def run(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                         lse.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 8 * rows,
                         dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, sk, d, *strides,
                         d ** -0.5, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")

            row = {}
            for name in [*named, *reversed(named)]:
                row.setdefault(name, []).append(
                    round(_time_ms(torch, lambda: run(named[name])), 4))
            print(f"{source} b{b} h{h} ms", (sq, sk, d), row, flush=True)
    return 0


# the d=256 instance's sub-step rows: as built, and the variant that spills
D256_VARIANTS = {"rows16": [], "rows32": [(r"launch<256, 2, 16>", "launch<256, 2, 32>")]}
D256_SHAPES = [(128, 256, 256), (128, 16, 256), (8, 200, 256), (8, 256, 248)]  # b, s, d at h1


def _build_variants(jobs, flags: int = 0) -> dict:
    """{name: the entry point of a patched copy}: ``jobs`` are (name, source
    file, entry, substitutions), each built into its own library, all nvcc
    processes started together; the ptxas lines of each build are printed.
    ``flags`` go to ``re.subn`` (``re.S`` for a pattern across lines)."""
    OUT.mkdir(parents=True, exist_ok=True)
    from dmtpu_torch.ops import _build
    procs = []
    for name, source, entry, substitutions in jobs:
        path = OUT / f"{name}.cu"
        path.write_text(patched((CSRC / source).read_text(), substitutions, flags))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o",
               str(path.with_suffix(".so")), str(path)]
        procs.append((name, entry, path.with_suffix(".so"), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    entries = {}
    for name, entry, lib, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{out[-3000:]}")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes, fn.restype = _build._SIGNATURES[entry], ctypes.c_int
        entries[name] = (fn, out.splitlines())
    return entries


def d256() -> int:
    import torch
    from dmtpu_torch.ops.flash_attention import (flash_attention_backward_reference,
                                                 flash_attention_fwd)
    built = _build_variants([(f"d256.{name}", "flash_attn_bwd_mma.cu",
                              "dmtpu_flash_attn_bwd_mma", subs)
                             for name, subs in D256_VARIANTS.items()])
    print(_card())
    for name, (_, log) in built.items():
        for i, line in enumerate(log):
            if "Compiling entry" in line and "ILi256E" in line:
                print(f"{name}:", " | ".join(x.strip()[:90] for x in log[i + 2:i + 4]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for b, s, d in D256_SHAPES:
        q, k, v, do = _case(torch, gen, b, s, s, 1, d)
        o, lse = flash_attention_fwd(q, k, v)
        want = flash_attention_backward_reference(q, k, v, o, lse, do)
        n_stat = -(-b * s // 4) * 4  # as the wrapper lays out its scratch
        scratch = torch.empty(n_stat + b * s * d, device="cuda")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        strides = [x for t in (q, k, v, o, do, dk, dv) for x in t.stride()[:3]]

        def run(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 4 * n_stat,
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, 1, s, s, d, *strides,
                     d ** -0.5, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        rel = {}
        for name, (fn, _) in built.items():
            run(fn)
            torch.cuda.synchronize()
            rel[name] = max(((a.float() - w.float()).norm() / w.float().norm()).item()
                            for a, w in zip((dq, dk, dv), want))
            bad += not rel[name] <= 1e-2
        row = {}
        for name in [*built, *reversed(list(built))]:
            row.setdefault(name, []).append(round(_time_ms(torch, lambda: run(built[name][0])), 4))
        row["sdpa_backward"] = round(_sdpa_backward_ms(torch, q, k, v, do), 4)
        print(f"K2 d256 b{b} h1 S={s} d={d}: rel L2 {rel}, ms {row}", flush=True)
    print("d256:", "FAILED" if bad else "all ok")
    return 1 if bad else 0


# b, sq, sk, h, d: CelebA-HQ's two shapes, ragged lengths (a last key tile of
# 8 keys, a last row step of 8 rows), padded head dims (504; 264 and 384: the
# second CTA of the wgmma pair's columns wholly or partly zero-filled), two
# heads, and b128 S=256, where the card and not the host sets the pace
D512_SHAPES = [(16, 256, 256, 1, 512), (16, 64, 64, 1, 512), (4, 200, 200, 1, 512),
               (4, 256, 256, 1, 504), (2, 77, 333, 2, 512), (2, 333, 40, 1, 264),
               (2, 100, 77, 2, 384), (128, 256, 256, 1, 512)]


def d512() -> int:
    import torch
    from dmtpu_torch.ops import _build, roofline
    from dmtpu_torch.ops.flash_attention import (flash_attention_backward_reference,
                                                 flash_attention_bwd, flash_attention_fwd,
                                                 select_bwd_kernel, wgmma_bwd_key_tile)
    lib = _build.build()
    _build.library()
    print(_card())
    log = (lib.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "C75" in line:
            print("  ", line.strip()[:300])
        if "Compiling entry" in line and re.search("flash_bwd_(d512|pair)_kernel", line):
            print("d512 ptxas:", " | ".join(x.strip()[:120] for x in log[i:i + 4]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for b, sq, sk, h, d in D512_SHAPES:
        q, k, v, do = _case(torch, gen, b, sq, sk, h, d)
        if (b, sq) == (2, 77):  # dO as a view of a wider tensor
            do = torch.randn(b, sq, h, 2 * d, generator=gen, device="cuda").bfloat16()[..., d:]
        o, lse = flash_attention_fwd(q, k, v)
        want = flash_attention_backward_reference(q, k, v, o, lse, do)
        line = f"K2 d512 b{b} sq{sq} sk{sk} h{h} d{d} (gate {select_bwd_kernel(d)}):"
        fns = {name: (lambda name=name: flash_attention_bwd(q, k, v, o, lse, do, kernel=name))
               for name in ("mma", "wgmma")}
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            for part, a, w in zip(("dq", "dk", "dv"), got, want):
                a, w = a.float(), w.float()
                err, rel = (a - w).abs().max().item(), ((a - w).norm() / w.norm()).item()
                ok = err <= 1e-2 * w.abs().max().item() and rel <= 1e-2 and \
                    bool(torch.isfinite(a).all())
                bad += not ok
                line += f" {name} {part} max err {err:.2e} rel L2 {rel:.2e} {'ok' if ok else 'BAD'};"
            if name == "wgmma" and sk <= wgmma_bwd_key_tile(d):
                same = all(torch.equal(x, y) for x, y in zip(got, fn()))
                bad += not same
                line += f" same bits again: {same};"
        ms = {}
        for name in ("mma", "wgmma", "wgmma", "mma"):
            ms.setdefault(name, []).append(round(_time_ms(torch, fns[name], 20), 4))
        device = {name: round(_device_ms(torch, fn), 4) for name, fn in fns.items()}
        sdpa = round(_sdpa_backward_ms(torch, q, k, v, do.contiguous(), device=True), 4)
        backend = sdpa_backend(torch, *(x.transpose(1, 2) for x in (q, k, v)))
        bound, by = roofline.bound_ms(*roofline.attention_bwd_work(b, h, sq, sk, d))
        line += (f" ms {ms}, device ms {device}, SDPA backward ({backend}) device ms {sdpa}, "
                 f"bound {bound:.4f} ({by})")
        print(line, flush=True)
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()
    print("d512:", "FAILED" if bad else "all ok")
    return 1 if bad else 0


# b, sq, sk, h, d: the column-split instances' shapes on the paths
FRESH_SHAPES = [(16, 256, 256, 8, 160), (16, 64, 64, 8, 160), (16, 256, 77, 8, 160),
                (16, 64, 77, 8, 160), (128, 256, 256, 1, 256), (128, 16, 16, 1, 256),
                (8, 200, 200, 1, 256), (8, 256, 256, 1, 248)]


def fresh() -> int:
    import torch
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.flash_attention import (flash_attention_backward_reference,
                                                 flash_attention_bwd, flash_attention_fwd,
                                                 select_bwd_kernel)
    print(_card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for b, sq, sk, h, d in FRESH_SHAPES:
        q, k, v, do = _case(torch, gen, b, sq, sk, h, d)
        o, lse = flash_attention_fwd(q, k, v)
        want = flash_attention_backward_reference(q, k, v, o, lse, do)
        fns = {name: (lambda name=name: flash_attention_bwd(q, k, v, o, lse, do, kernel=name))
               for name in ("mma", "wgmma")}
        rel = {}
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            rel[name] = max(((a.float() - w.float()).norm() / w.float().norm()).item()
                            for a, w in zip(got, want))
            bad += not rel[name] <= 1e-2
        ms = {}
        for name in ("mma", "wgmma", "wgmma", "mma"):
            ms.setdefault(name, []).append(round(_time_ms(torch, fns[name], 20), 4))
        device = {name: round(_device_ms(torch, fn), 4) for name, fn in fns.items()}
        sdpa = round(_sdpa_backward_ms(torch, q, k, v, do), 4)
        sdpa_device = round(_sdpa_backward_ms(torch, q, k, v, do, device=True), 4)
        backend = sdpa_backend(torch, *(x.transpose(1, 2) for x in (q, k, v)))
        bound, by = roofline.bound_ms(*roofline.attention_bwd_work(b, h, sq, sk, d))
        print(f"K2 b{b} h{h} S_q={sq} S_k={sk} d={d} (gate {select_bwd_kernel(d)}): rel L2 "
              f"{rel}, ms {ms}, device ms {device}, SDPA backward ({backend}) ms {sdpa}, "
              f"device ms {sdpa_device}, bound {bound:.4f} ({by})", flush=True)
        # the wgmma call's kernels apart: the first pass, the main kernel, the cast
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fns["wgmma"]()
            torch.cuda.synchronize()
        print("    wgmma by kernel, device ms:", {
            re.search(r"flash_bwd_\w+", e.key)[0]: round(e.self_device_time_total / 1e4, 4)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "flash_bwd_" in e.key},
            flush=True)
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()
    print("fresh:", "FAILED" if bad else "all ok")
    return 1 if bad else 0


PHASES = {"check": check, "time": timing, "variants": variants, "d256": d256, "d512": d512,
          "fresh": fresh}


def main(argv: list[str]) -> int:
    if argv:
        return PHASES[argv[0]]()
    for phase, limit in PHASE_LIMITS.items():
        try:
            rc = subprocess.run([sys.executable, "-m", "dmtpu_torch.dev.k2_probe", phase],
                                cwd=ROOT, timeout=limit).returncode
        except subprocess.TimeoutExpired:
            print(f"{phase}: no end within {limit} s (a hung kernel?)")
            return 5
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
