"""Development probe of K1 (attention forward) on one CUDA card.

    python -m dmtpu_torch.dev.k1_probe          # check, then time
    python -m dmtpu_torch.dev.k1_probe time     # one phase

- ``check``: builds the kernels, prints what ``ptxas`` said of each instance
  of the wgmma kernel (registers, spills, shared memory, any C75xx remark),
  and holds the wgmma kernel against K1's plain version at every instance
  (head dims 40, 64, 72, 80, 160, 256, 512), at head dims between them (run on
  the next wider instance), at ragged lengths, at key counts on either side
  of the short-key tile, and on strided q/k/v views.
- ``time``: at every K1 shape of the repository's paths whose head dim has a
  wgmma instance, the mma.sync kernel, the wgmma kernel as built and copies
  of it built without its short-key tile, with one work item a CTA, and
  with O written by 4-byte stores, or by 16-byte stores, at every head dim
  (``build/dev/variants/``; the last three must give the same bits, the
  first agree within 1e-2 max|o|), in turns (each in order, then in
  reverse), beside
  ``scaled_dot_product_attention`` and the bound (``ops/roofline.py``): CUDA
  events around 20 calls (``ms``; at small shapes the host's time to launch
  one), then the device time of each alone (``device ms``, ``torch.profiler``).
  The gate in ``dmtpu_torch/ops/flash_attention.py::select_kernel`` is read
  off these rows.

- ``d512``: the d=512 instance against the mma.sync kernel's
  (``csrc/flash_attn_fwd_mma_d512.cu``) at CelebA-HQ's shapes (b16 h1
  S=256 and S=64), a ragged b4 S=200, d=504 and b128 S=256 (where the card,
  not the host, sets the pace): both in turns by CUDA events over 20 calls
  and alone by device time, beside SDPA (its backend named) and the bound.
- ``variants``: what the wgmma kernel's time is made of, at CIFAR's d=256,
  three SD1.5 rows and CelebA-HQ's d=512 at b128 and b16: patched copies built side by side and timed in
  turns, as built, without the O stores and without the products (loads,
  softmax and stores only).  The patched kernels compute wrong values; only
  their times are read.

With no argument each phase runs in a process of its own with a time limit: a
kernel that hangs on an mbarrier would otherwise never return.
"""
from __future__ import annotations

import re
import subprocess
import sys
import time
from pathlib import Path

from dmtpu_torch.dev.k2_probe import (_build_variants, _card, _device_ms, _time_ms,
                                      sdpa_backend)

ROOT = Path(__file__).resolve().parents[2]
_CSRC = ROOT / "dmtpu_torch" / "csrc"
PHASE_LIMITS = {"check": 240, "time": 420, "d512": 180, "variants": 300}  # seconds

CHECK_SHAPES = [  # b, sq, sk, h, d
    # the new instances at SD1.5's shapes (b2), ragged lengths, padded head dims
    (2, 256, 256, 8, 160), (2, 64, 64, 8, 160), (2, 256, 77, 8, 160), (2, 64, 77, 8, 160),
    (2, 333, 200, 3, 160), (2, 200, 333, 3, 152), (1, 1, 130, 1, 160), (2, 100, 65, 2, 160),
    (8, 256, 256, 1, 256), (8, 16, 16, 1, 256), (8, 200, 200, 1, 256), (4, 256, 256, 1, 248),
    (2, 77, 333, 2, 256), (2, 333, 40, 1, 256), (2, 64, 64, 1, 256), (1, 1, 1, 1, 256),
    # in-between head dims on the next wider instance
    (2, 130, 150, 2, 8), (2, 130, 150, 2, 32), (2, 130, 150, 2, 48), (2, 130, 150, 2, 56),
    (2, 130, 150, 2, 96), (2, 130, 150, 2, 200),
    # the short-key tile and the key counts on either side of it
    (2, 4096, 77, 8, 40), (2, 1024, 77, 8, 80), (2, 300, 77, 3, 64), (2, 100, 64, 2, 40),
    (2, 100, 80, 2, 80), (2, 100, 81, 2, 80), (2, 300, 1, 2, 40), (2, 77, 77, 3, 72),
    # the earlier instances at their paths' shapes
    (2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (4, 256, 256, 16, 72), (2, 333, 333, 3, 64),
    # the d=512 instance: CelebA-HQ's shapes (b16 h1 S=256 and S=64), ragged
    # lengths, padded head dims (504, 384, 264: the second half of the columns
    # partly or wholly zero-filled), one key and one row
    (16, 256, 256, 1, 512), (16, 64, 64, 1, 512), (4, 200, 200, 1, 512), (4, 256, 256, 1, 504),
    (2, 77, 333, 2, 512), (2, 333, 40, 1, 264), (2, 100, 65, 2, 384), (1, 1, 1, 1, 512),
    (128, 256, 256, 1, 512),
]
STRIDED_SHAPES = [(2, 256, 8, 160), (4, 256, 1, 256), (4, 256, 16, 72),
                  (4, 256, 1, 512)]  # b, s, h, d

# b, h, sq, sk, d: K1's calls on the repository's paths at head dims with a
# wgmma instance (chip_smoke.py's rows)
TIMED_SHAPES = [
    *((n, 8, sq, sk, d) for n in (16, 32) for sq, sk, d in [
        (4096, 4096, 40), (1024, 1024, 80), (256, 256, 160), (64, 64, 160),
        (4096, 77, 40), (1024, 77, 80), (256, 77, 160), (64, 77, 160)]),  # SD1.5
    (2, 10, 4096, 77, 64), (2, 20, 1024, 77, 64),  # SDXL's cross-attention
    (16, 8, 64, 64, 64),  # ADM-256's 8x8 level
    (500, 1, 256, 256, 256), (500, 1, 16, 16, 256), (500, 1, 200, 200, 256),  # CIFAR UNet
    (20, 1, 256, 256, 256), (20, 1, 16, 16, 256),  # the AdaGN UNet's CFG batch
    (128, 1, 64, 64, 256), (128, 1, 256, 256, 256),  # a ring hop of 4 chunks, CIFAR train
]

# the patches that build the wgmma kernel without its short-key tile, and
# with one work item a CTA (a grid of every Q tile) instead of one CTA per SM
NO_SHORT_TILE = (r"return kShort && Sk <= kShortKeys", "return false && Sk <= kShortKeys")
ONE_ITEM_PER_CTA = (r"constexpr bool kPersistent = true;", "constexpr bool kPersistent = false;")
FOUR_BYTE_STORES = (r"constexpr int kWholeBlockMinD = \d+;", "constexpr int kWholeBlockMinD = 4096;")
WHOLE_BLOCK_STORES = (r"constexpr int kWholeBlockMinD = \d+;", "constexpr int kWholeBlockMinD = 0;")
VARIANTS = {"wgmma_no_short": NO_SHORT_TILE, "wgmma_one_item": ONE_ITEM_PER_CTA,
            "wgmma_4b_stores": FOUR_BYTE_STORES, "wgmma_16b_stores": WHOLE_BLOCK_STORES}


def check() -> int:
    import torch
    from dmtpu_torch.ops import _build
    from dmtpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_reference
    t0 = time.time()
    lib = _build.build()
    _build.library()
    print(f"built and loaded in {time.time() - t0:.1f} s", flush=True)
    log = (lib.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "C75" in line or "error" in line.lower():
            print("  ", line.strip()[:300])
        instance = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)E", line)
        if instance and "Compiling" in line:
            print(f"   D={instance[1]} N={instance[2]}:",
                  " | ".join(x.strip()[12:] for x in log[i + 2:i + 4]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    cases = [(shape, False) for shape in CHECK_SHAPES]
    cases += [((b, s, s, h, d), True) for b, s, h, d in STRIDED_SHAPES]
    for (b, sq, sk, h, d), strided in cases:
        if strided:
            qkv = torch.randn(b, sq, 3, h, d, generator=gen, device="cuda").bfloat16()
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                       for s in (sq, sk, sk))
        want_o, want_lse = flash_attention_reference(q, k, v)
        before = flash_attention_fwd.launches_by_kernel["wgmma"]
        o, lse = flash_attention_fwd(q, k, v, kernel="wgmma")
        torch.cuda.synchronize()
        err = (o.float() - want_o.float()).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        ok = (err <= 1e-2 * want_o.float().abs().max().item() and err_lse <= 1e-3
              and bool(torch.isfinite(o).all())
              and flash_attention_fwd.launches_by_kernel["wgmma"] == before + 1)
        bad += not ok
        print(f"wgmma b{b} sq{sq} sk{sk} h{h} d{d}{' strided' if strided else ''}: max err "
              f"{err:.2e} lse {err_lse:.2e} {'ok' if ok else 'BAD'}", flush=True)
        if not ok:  # where it is wrong: by block of 16 rows, and by column
            diff = (o.float() - want_o.float()).abs()[0, :, 0]
            rows = diff.amax(-1)[:diff.shape[0] // 16 * 16].reshape(-1, 16).amax(-1)
            print("    rows:", [round(x, 3) for x in rows[:16].tolist()],
                  "columns:", [round(x, 3) for x in diff.amax(0).tolist()][:64])
    print("check:", "FAILED" if bad else "all ok")
    return 1 if bad else 0


def timing() -> int:
    import torch
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.flash_attention import _LOG2E, flash_attention_fwd, select_kernel
    built = _build_variants([(f"k1.{name}", "flash_attn_fwd.cu", "dmtpu_flash_attn_fwd", [patch])
                             for name, patch in VARIANTS.items()])
    print(_card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for b, h, sq, sk, d in TIMED_SHAPES:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                   for s in (sq, sk, sk))
        out = torch.empty_like(q)
        lse = torch.empty(b, h, sq, device="cuda")

        def variant(fn):
            def run():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         lse.data_ptr(), b, h, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
                         *v.stride()[:3], *out.stride()[:3], d ** -0.5 * _LOG2E,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            return run

        fns = {"mma": lambda: flash_attention_fwd(q, k, v, kernel="mma"),
               "wgmma": lambda: flash_attention_fwd(q, k, v, kernel="wgmma"),
               **{name: variant(built[f"k1.{name}"][0]) for name in VARIANTS}}
        # the variants compute what the kernel as built does: the same bits,
        # or within K1's bound (1e-2 max|o|) with another key tile
        want = flash_attention_fwd(q, k, v, kernel="wgmma")[0].float()
        for name in VARIANTS:
            fns[name]()
            err = (out.float() - want).abs().max().item()
            bad += not (err == 0 if name != "wgmma_no_short"
                        else err <= 1e-2 * want.abs().max().item())
        order = list(fns)
        row = {}
        for name in order + order[::-1]:
            row.setdefault(name, []).append(round(_time_ms(torch, fns[name], 20), 4))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fns["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        row["sdpa"] = round(_time_ms(torch, fns["sdpa"], 20), 4)
        device = {name: round(_device_ms(torch, fn), 4) for name, fn in fns.items()}
        bound, by = roofline.bound_ms(*roofline.attention_fwd_work(b, h, sq, sk, d))
        print(f"K1 b{b} h{h} S_q={sq} S_k={sk} d={d}: ms {row}, device ms {device}, bound "
              f"{bound:.4f} ({by}), gate {select_kernel(d)}", flush=True)
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    print("time:", f"{bad} variant outputs differ" if bad else "the variants agree")
    return 1 if bad else 0


# b, h, sq, sk, d: CelebA-HQ's two shapes, a ragged length, a padded head
# dim, and a batch where the card sets the pace
D512_SHAPES = [(16, 1, 256, 256, 512), (16, 1, 64, 64, 512), (4, 1, 200, 200, 512),
               (4, 1, 256, 256, 504), (128, 1, 256, 256, 512)]


def d512() -> int:
    import torch
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.flash_attention import (flash_attention_fwd, flash_attention_reference,
                                                 select_kernel)
    print(_card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for b, h, sq, sk, d in D512_SHAPES:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                   for s in (sq, sk, sk))
        want = flash_attention_reference(q, k, v)[0].float()
        fns = {name: (lambda name=name: flash_attention_fwd(q, k, v, kernel=name))
               for name in ("mma", "wgmma")}
        err = {}
        for name, fn in fns.items():
            err[name] = (fn()[0].float() - want).abs().max().item()
            bad += not err[name] <= 1e-2 * want.abs().max().item()
        ms = {}
        for name in ("mma", "wgmma", "wgmma", "mma"):
            ms.setdefault(name, []).append(round(_time_ms(torch, fns[name], 20), 4))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fns["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        ms["sdpa"] = round(_time_ms(torch, fns["sdpa"], 20), 4)
        device = {name: round(_device_ms(torch, fn), 4) for name, fn in fns.items()}
        bound, by = roofline.bound_ms(*roofline.attention_fwd_work(b, h, sq, sk, d))
        print(f"K1 b{b} h{h} S_q={sq} S_k={sk} d={d} (gate {select_kernel(d)}): max err "
              f"{err}, ms {ms}, device ms {device}, SDPA backend "
              f"{sdpa_backend(torch, qt, kt, vt)}, bound {bound:.4f} ({by})", flush=True)
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()
    print("d512:", "FAILED" if bad else "all ok")
    return 1 if bad else 0


# what each diagnostic copy of the wgmma kernel leaves out
_NO_O_STORE = (r"\*reinterpret_cast<uint4\*>\(orow \+ \(n0 \+ t\) \* 8\) = w;",
               "if (w.x == 0x12345678u) *reinterpret_cast<uint4*>(orow) = w;")
_NO_PRODUCTS = (r"(__device__ __forceinline__ void wgmma_(?:qk|pv)\(.*?\) \{).*?\n\}", r"\1\n}")
DIAGNOSTICS = {"as_it_is": [], "no_o_store": [_NO_O_STORE], "no_products": [_NO_PRODUCTS]}
DIAGNOSTIC_SHAPES = [(500, 1, 256, 256, 256), (16, 8, 256, 256, 160), (16, 8, 4096, 77, 40),
                     (16, 8, 1024, 77, 80), (128, 1, 256, 256, 512),
                     (16, 1, 256, 256, 512)]  # b, h, sq, sk, d


def variants() -> int:
    import re as _re

    import torch
    from dmtpu_torch.ops.flash_attention import _LOG2E
    source = (_CSRC / "flash_attn_fwd.cu").read_text()
    for name, subs in DIAGNOSTICS.items():  # a pattern that finds nothing raises
        for pattern, _ in subs:
            if not _re.search(pattern, source, flags=_re.S):
                raise ValueError(f"{name}: pattern matches nothing: {pattern}")
    built = _build_variants([(f"k1diag.{name}", "flash_attn_fwd.cu", "dmtpu_flash_attn_fwd",
                              subs) for name, subs in DIAGNOSTICS.items()], flags=_re.S)
    print(_card(), flush=True)
    for name, (_, log) in built.items():
        for i, line in enumerate(log):
            if "Compiling entry" in line and "ILi256E" in line:
                print(f"{name} d=256:", " | ".join(x.strip()[12:] for x in log[i + 2:i + 4]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, sq, sk, d in DIAGNOSTIC_SHAPES:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                   for s in (sq, sk, sk))
        out = torch.empty_like(q)
        lse = torch.empty(b, h, sq, device="cuda")

        def run(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     b, h, sq, sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     *out.stride()[:3], d ** -0.5 * _LOG2E,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        names = list(built)
        row = {}
        for name in names + names[::-1]:
            row.setdefault(name, []).append(
                round(_time_ms(torch, lambda: run(built[name][0]), 20), 4))
        device = {name: round(_device_ms(torch, lambda: run(built[name][0])), 4)
                  for name in names}
        print(f"K1 wgmma b{b} h{h} S_q={sq} S_k={sk} d={d}: ms {row}, device ms {device}",
              flush=True)
    return 0


PHASES = {"check": check, "time": timing, "d512": d512, "variants": variants}


def main(argv: list[str]) -> int:
    if argv:
        return PHASES[argv[0]]()
    for phase, limit in PHASE_LIMITS.items():
        try:
            rc = subprocess.run([sys.executable, "-m", "dmtpu_torch.dev.k1_probe", phase],
                                cwd=ROOT, timeout=limit).returncode
        except subprocess.TimeoutExpired:
            print(f"{phase}: no end within {limit} s (a hung kernel?)")
            return 5
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
