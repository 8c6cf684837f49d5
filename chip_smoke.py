#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py            # from the repository root, one card

The port's paths are SD1.5 text-to-latent sampling and SD1.5 training: the
full-width SD1.5 UNet (``model_channels`` 320, ``context_dim`` 768, 8 heads,
``channel_mult`` (1, 2, 4, 4)) with f32 parameters, a bf16 torso and f32
GroupNorm / softmax, random weights from a seed, on 64x64x4 latents with a
77x768 context; sampled with DDIM-50, and trained with the DDPM eps-loss
(1000 steps), full remat (``use_checkpoint=True``), adafactor (lr 1e-4),
gradient clipping at 1.0 and a gradual EMA (0.9999) with a bf16 shadow.

Phases (any failure exits non-zero, and the last line is then not printed):
  1. the card's name and power limit; the kernels built from ``dmtpu_torch/csrc``;
  2. K1 (attention forward; two kernels, wgmma and mma.sync, behind one
     dispatch) against the plain ``mha`` and against its own plain version,
     bf16, at every attention shape of the path: every kernel that takes the
     shape is checked and timed (order first, second, second, first), the row
     names the one the dispatch chose, and that one must not be the slower.
     Beside ``ms`` and ``plain_ms`` each row has ``bound_ms`` (the least time
     the card could take, ``dmtpu_torch/ops/roofline.py``) and what bounds it,
     ``library_ms`` (``F.scaled_dot_product_attention`` on [B, H, S, D] views
     of the same tensors, default backend, timed as a yardstick and used
     nowhere in the port), ``host_us`` (host clock over 200 calls of the
     wrapper with no synchronise, per call) and ``host_bound`` (``ms`` within
     20% of ``host_us``);
  3. K3 (GroupNorm+SiLU) against its plain version at every GroupNorm shape
     of the path, bf16 and f32, SiLU on and off, eps 1e-5 and 1e-6,
     channels-last (both kernels, "rows" and the per-group one, as in 2) and
     NCHW; two runs must agree bit for bit; the same columns, ``library_ms``
     being ``F.group_norm`` (weight and bias cast to x's dtype in the call, as
     a caller with f32 parameters has to) followed by ``F.silu``;
  4. one UNet forward through the kernels and one through the plain ops, each
     measured against an f32 plain run (TF32 off): the kernel path must come
     within 1.5x the plain path's error, plus 1e-3; then the batch-16 UNet
     forward time through the kernels and through the plain ops (CUDA events,
     order plain, kernels, kernels, plain) and a ``torch.profiler`` breakdown
     of the kernel path's device time by class of kernel;
  5. requests: DDIM-50 at batch 16 (one warm-up, one timed run, with the
     launch counts of the timed run) and DDIMCFG s=7.5 at batch 2: its guided
     noise prediction at the first step and its sample after a few steps,
     each held against the f32 plain path within 1.5x the plain bf16 path's
     error;
  6. K2 (attention backward; two kernels, wgmma and mma.sync, behind one
     dispatch) at every attention shape of the path, b16 bf16: as in 2, every
     kernel that takes the shape is checked (dq, dk and dv against K2's plain
     version and against f32 autograd through ``mha``) and timed, the row
     names the one the dispatch chose, and that one must not be the slower;
     where one CTA holds all of a dq row's sum (one key tile, wgmma) two runs
     must agree bit for bit; the columns of 2 (``library_ms``: forward and
     backward of one SDPA call, less its forward alone);
  7. training: (a) at batch 2, one fixed batch, t and eps: the loss and the
     gradient through the kernels against an f32 plain run (TF32 off), within
     1.5x the plain bf16 path's relative error plus 1e-3; (b) the launches
     of K1, K2 and K3 per step, derived from the module tree and checked
     exactly, K2's also by kernel as its dispatch predicts; (c) at batch 16:
     one warm-up step, then 10 timed steps (images per second, ms per step,
     peak memory) and a ``torch.profiler`` breakdown of one step; (d) 10 steps on one fixed batch 2: the kernel
     path's loss is finite and falls, and stays within 1e-3 of the plain
     bf16 path's loss at the same weights at every step.

Before the last line it prints one JSON object with each kernel's launches in
the timed main-path runs (K1 and K3 in DDIM-50, K2 in the 10 train steps,
and all three counted in each of the two runs), error, and its times, bound,
library time and host time summed over the calls of one forward (K2: of one
train step), and the card's name and power limit.  The last line is
``{"ok": true, "device": {...}}``.  It needs no network and leaves no
process behind.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

B = 16                      # the headline batch
STEPS = 50                  # DDIM-50 over 1000 training steps, uniform respacing
CFG_BATCH, CFG_STEPS, CFG_SCALE = 2, 5, 7.5
UNET_CHECK_BATCH = 2
UNET_TIMED_FORWARDS, UNET_PROFILED_FORWARDS = 10, 3
TRAIN_CHECK_BATCH, TRAIN_TIMED_STEPS, LEARN_STEPS = 2, 10, 10
TRAIN_LR, TRAIN_CLIP, EMA_DECAY = 1e-4, 1.0, 0.9999
SEED = 0

SD15 = dict(in_channels=4, model_channels=320, out_channels=4, num_res_blocks=2,
            attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4), num_heads=8,
            use_spatial_transformer=True, transformer_depth=1, context_dim=768, legacy=False)

# One SD1.5 UNet forward, read off the module tree (16 SpatialTransformers,
# each a self- and a cross-attention; heads 8).  (S_q, S_k, d): calls.
ATTN_CALLS = {
    (4096, 4096, 40): 5, (1024, 1024, 80): 5, (256, 256, 160): 5, (64, 64, 160): 1,
    (4096, 77, 40): 5, (1024, 77, 80): 5, (256, 77, 160): 5, (64, 77, 160): 1,
}
# (C, H*W, dtype, silu, eps): calls.  22 ResBlocks x 2 (bf16, SiLU, 1e-5),
# 16 SpatialTransformer norms (bf16, no SiLU, 1e-6), the output norm (f32).
GN_CALLS = {
    (320, 4096, "bf16", True, 1e-5): 7, (640, 4096, "bf16", True, 1e-5): 2,
    (960, 4096, "bf16", True, 1e-5): 1, (320, 1024, "bf16", True, 1e-5): 1,
    (640, 1024, "bf16", True, 1e-5): 6, (960, 1024, "bf16", True, 1e-5): 1,
    (1280, 1024, "bf16", True, 1e-5): 1, (1920, 1024, "bf16", True, 1e-5): 1,
    (640, 256, "bf16", True, 1e-5): 1, (1280, 256, "bf16", True, 1e-5): 6,
    (1920, 256, "bf16", True, 1e-5): 1, (2560, 256, "bf16", True, 1e-5): 2,
    (1280, 64, "bf16", True, 1e-5): 11, (2560, 64, "bf16", True, 1e-5): 3,
    (320, 4096, "bf16", False, 1e-6): 5, (640, 1024, "bf16", False, 1e-6): 5,
    (1280, 256, "bf16", False, 1e-6): 5, (1280, 64, "bf16", False, 1e-6): 1,
    (320, 4096, "f32", True, 1e-5): 1,
}
ATTN_PER_FORWARD = sum(ATTN_CALLS.values())   # 32
GN_PER_FORWARD = sum(GN_CALLS.values())       # 61


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dmtpu_torch.diffusions import DDIM, DDIMCFG
    from dmtpu_torch.models.stablediffusion import SDUNetModel
    from dmtpu_torch.ops import _build, plain_ops, roofline
    from dmtpu_torch.ops.attention import mha
    from dmtpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        flash_attention_reference,
        kernels_for,
        select_kernel,
    )
    from dmtpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_reference
    from dmtpu_torch.ops import groupnorm as groupnorm_module
    from dmtpu_torch.ops.groupnorm import kernels_for as gn_kernels_for
    from dmtpu_torch.ops.groupnorm import plan as gn_plan

    dev = torch.device("cuda")
    failures: list[str] = []

    def check(ok: bool, what: str) -> None:
        log(("PASS " if ok else "FAIL ") + what)
        if not ok:
            failures.append(what)

    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def host_us(fn, reps: int) -> float:
        """Host time of one call of ``fn``: the host clock over ``reps`` calls
        with no synchronise between them, in microseconds per call."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * seconds / reps

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- 1. card and build ------------------------------------------------
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib_path}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    # ---- 2. K1 ------------------------------------------------------------
    log("SDPA backends enabled: " + json.dumps({
        name: bool(getattr(torch.backends.cuda, f"{name}_sdp_enabled")())
        for name in ("flash", "mem_efficient", "math", "cudnn")
        if hasattr(torch.backends.cuda, f"{name}_sdp_enabled")}))
    k1 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, host_us=0.0, err=0.0,
              bound_ms_by={"bytes": 0.0, "operations": 0.0})
    g = gen(SEED)
    for (sq, sk, d), calls in ATTN_CALLS.items():
        q = torch.randn(B, sq, 8, d, generator=g, device=dev).bfloat16()
        k = torch.randn(B, sk, 8, d, generator=g, device=dev).bfloat16()
        v = torch.randn(B, sk, 8, d, generator=g, device=dev).bfloat16()
        ref_o, ref_lse = flash_attention_reference(q, k, v)
        plain = mha(q, k, v)
        chosen = select_kernel(sq, sk, d)
        names = kernels_for(d)
        # bf16 output: one bf16 step (2^-8 relative) of the largest outputs on
        # top of P rounded to bf16 in both versions; a skipped or doubled K/V
        # tile moves outputs by about a tenth of max|o|.  mha also rounds its
        # logits to bf16 where S_q*S_k <= 2**21
        bound = 1e-2 * ref_o.float().abs().max().item()
        errs = {}
        for name in names:
            o, lse = flash_attention_fwd(q, k, v, kernel=name)
            torch.cuda.synchronize()
            err_ref = (o.float() - ref_o.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            err_mha = (o.float() - plain.float()).abs().max().item()
            rel_mha = err_mha / plain.float().abs().max().item()
            errs[name] = dict(max_abs_err_vs_mha=err_mha, rel_err_vs_mha=rel_mha,
                              max_abs_err_vs_own_plain=err_ref, lse_max_abs_err=err_lse)
            check(err_ref <= bound and err_lse <= 1e-3 and rel_mha <= 3e-2 and
                  bool(torch.isfinite(o).all()),
                  f"K1[{name}] bf16 b{B} h8 S_q={sq} S_k={sk} d={d}")
            del o, lse
        # each hand-written kernel that takes the shape, in the order first,
        # second, second, first: the dispatch must not pick the slower one
        by_kernel = {name: [] for name in names}
        for name in names + names[::-1]:
            by_kernel[name].append(
                time_ms(lambda: flash_attention_fwd(q, k, v, kernel=name), 20))
        ms = sum(by_kernel[chosen]) / len(by_kernel[chosen])
        plain_ms = time_ms(lambda: mha(q, k, v), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, S, D] views
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 20)
        host = host_us(lambda: flash_attention_fwd(q, k, v), 200)
        bound_t, bound_by = roofline.bound_ms(*roofline.attention_fwd_work(B, 8, sq, sk, d))
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_t),
                           ("library_ms", library_ms), ("host_us", host)):
            k1[key] += calls * value
        k1["bound_ms_by"][bound_by] += calls * bound_t
        k1["err"] = max(k1["err"], errs[chosen]["max_abs_err_vs_mha"])
        log("K1", json.dumps(dict(
            b=B, h=8, sq=sq, sk=sk, d=d, calls=calls, kernel=chosen, **errs[chosen], ms=ms,
            ms_by_kernel=by_kernel, plain_ms=plain_ms, bound_ms=bound_t, bound_by=bound_by,
            library_ms=library_ms, host_us=host, host_bound=ms <= 1.2 * host / 1e3)))
        check(not_the_slower(by_kernel, chosen, ms, host),
              f"K1 dispatch S_q={sq} S_k={sk} d={d}: {chosen} is not the slower kernel")
        del q, k, v, qt, kt, vt, ref_o, ref_lse, plain
    log(f"K1 per b{B} UNet forward ({ATTN_PER_FORWARD} calls): " + json.dumps(k1))
    torch.cuda.empty_cache()

    # ---- 3. K3 ------------------------------------------------------------
    k3 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, host_us=0.0, err=0.0,
              bound_ms_by={"bytes": 0.0, "operations": 0.0})
    pairs = sorted({(c, hw) for c, hw, *_ in GN_CALLS})
    # the UNet's activations are channels-last (cuDNN returns its bf16
    # convolutions so); NCHW is checked too, and timed but not summed
    cl, nchw = torch.channels_last, torch.contiguous_format
    variants = [("bf16", True, 1e-5, cl), ("bf16", False, 1e-6, cl), ("f32", True, 1e-5, cl),
                ("f32", False, 1e-6, cl), ("bf16", True, 1e-5, nchw), ("f32", False, 1e-6, nchw)]

    def library_gn(x, w, bias, eps, silu):
        # the library's GroupNorm wants weight and bias in x's dtype: the
        # caller, whose parameters are f32, casts them in every call
        y = torch.nn.functional.group_norm(x, 32, w.to(x.dtype), bias.to(x.dtype), eps)
        return torch.nn.functional.silu(y) if silu else y

    for c, hw in pairs:
        for dname, silu, eps, layout in variants:
            dtype = torch.bfloat16 if dname == "bf16" else torch.float32
            side = int(hw ** 0.5)
            x = (torch.randn(B, c, side, side, generator=g, device=dev) * 2 + 0.5).to(
                dtype=dtype, memory_format=layout)
            w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
            bias = 0.1 * torch.randn(c, generator=g, device=dev)
            ref = group_norm_silu_reference(x, w, bias, 32, eps, silu)
            names = list(gn_kernels_for(c, hw, 32, layout == cl))
            chosen = gn_plan(c, hw, 32, x.element_size(), layout == cl, B)["kernel"]
            # f32: summation order only.  bf16: the two round f32 values that
            # differ in the last f32 bits, so they may land one bf16 step
            # (at most 2^-7 of the value) apart
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
            errs = {}
            for name in names:
                y = group_norm_silu(x, w, bias, 32, eps, silu, kernel=name)
                again = group_norm_silu(x, w, bias, 32, eps, silu, kernel=name)
                torch.cuda.synchronize()
                diff = (y.float() - ref.float()).abs()
                errs[name] = diff.max().item()
                check(bool((diff <= tol * ref.float().abs() + 1e-4).all())
                      and bool(torch.isfinite(y).all()) and torch.equal(y, again)
                      and y.is_contiguous(memory_format=layout),
                      f"K3[{name}] {dname} silu={silu} eps={eps} {layout} b{B} C={c} HW={hw}")
                del y, again, diff
            calls = GN_CALLS.get((c, hw, dname, silu, eps), 0) if layout == cl else 0
            by_kernel = {name: [] for name in names}
            for name in names + names[::-1]:
                by_kernel[name].append(time_ms(
                    lambda: group_norm_silu(x, w, bias, 32, eps, silu, kernel=name), 20))
            ms = sum(by_kernel[chosen]) / len(by_kernel[chosen])
            plain_ms = time_ms(lambda: group_norm_silu_reference(x, w, bias, 32, eps, silu), 3)
            library_ms = time_ms(lambda: library_gn(x, w, bias, eps, silu), 10)
            host = host_us(lambda: group_norm_silu(x, w, bias, 32, eps, silu), 200)
            bound_t, bound_by = roofline.bound_ms(
                *roofline.group_norm_work(B, c, hw, x.element_size(), silu),
                peak_flops=roofline.PEAK_F32_FLOPS)
            for key, value in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_t),
                               ("library_ms", library_ms), ("host_us", host)):
                k3[key] += calls * value
            k3["bound_ms_by"][bound_by] += calls * bound_t
            k3["err"] = max(k3["err"], errs[chosen])
            log("K3", json.dumps(dict(
                b=B, c=c, hw=hw, dtype=dname, silu=silu, eps=eps,
                layout="NHWC" if layout == cl else "NCHW", calls=calls, kernel=chosen,
                max_abs_err=errs[chosen], ms=ms, ms_by_kernel=by_kernel, plain_ms=plain_ms,
                bound_ms=bound_t, bound_by=bound_by, library_ms=library_ms, host_us=host,
                host_bound=ms <= 1.2 * host / 1e3)))
            check(not_the_slower(by_kernel, chosen, ms, host),
                  f"K3 dispatch {dname} silu={silu} {layout} C={c} HW={hw}: {chosen} is not "
                  f"the slower kernel")
            del x, ref
    log(f"K3 per b{B} UNet forward ({GN_PER_FORWARD} calls): " + json.dumps(k3))
    # how the rows kernel's time depends on the CTAs a sample is spread over
    # (the plan aims at 64 in all), beside what the card's memory system gives a
    # plain copy (one read, one write) and a plain sum (one read) of the same x
    x = torch.randn(B, 320, 64, 64, generator=g, device=dev).to(
        dtype=torch.bfloat16, memory_format=cl)
    w, bias = torch.ones(320, device=dev), torch.zeros(320, device=dev)
    planned = gn_plan(320, 4096, 32, 2, True, B)
    by_cluster = {}
    for n_eff in (B * 8, B * 4, B * 2, B, B // 2):  # the plan's cluster for this many samples
        cluster = gn_plan(320, 4096, 32, 2, True, n_eff)["cluster"]
        with forced_plan(groupnorm_module, dict(planned, cluster=cluster)):
            by_cluster[cluster] = time_ms(lambda: group_norm_silu(x, w, bias, 32, 1e-5, True), 20)
    log("K3 rows kernel, b16 (320, 4096) bf16 SiLU, ms by CTAs per sample: "
        + json.dumps(by_cluster) + f"; planned {planned['cluster']}; x.clone() "
        f"{time_ms(lambda: x.clone(), 20):.4f} ms, x.sum() {time_ms(lambda: x.sum(), 20):.4f} ms")
    del x
    torch.cuda.empty_cache()

    # ---- 4. the full-width UNet: kernels vs plain vs f32 -------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    ref_model = SDUNetModel(**SD15, device=dev).eval()
    init_random_(ref_model, gen(SEED + 1))
    model = SDUNetModel(**SD15, torso_dtype=torch.bfloat16, device=dev).eval()
    model.load_state_dict(ref_model.state_dict())
    log(f"SD1.5 UNet: {sum(p.numel() for p in model.parameters())} params, bf16 torso")

    def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
        return ((a.float() - ref).norm() / ref.norm()).item()

    g = gen(SEED + 2)
    x = torch.randn(UNET_CHECK_BATCH, 4, 64, 64, generator=g, device=dev)
    ts = torch.tensor([999, 421], device=dev)[:UNET_CHECK_BATCH]
    ctx = torch.randn(UNET_CHECK_BATCH, 77, 768, generator=g, device=dev)
    with torch.no_grad():
        with plain_ops():
            want = ref_model(x, ts, ctx)
        flash_attention_fwd.launches = group_norm_silu.launches = 0
        got_k = model(x, ts, ctx)
        torch.cuda.synchronize()
        launches = (flash_attention_fwd.launches, group_norm_silu.launches)
        with plain_ops():
            got_p = model(x, ts, ctx)
    err_k, err_p = rel_err(got_k, want), rel_err(got_p, want)
    log(f"UNet b{UNET_CHECK_BATCH} forward: rel L2 err vs f32 plain: kernels {err_k:.3e}, "
        f"plain bf16 {err_p:.3e}; max abs: kernels "
        f"{(got_k.float() - want).abs().max().item():.3e}, plain "
        f"{(got_p.float() - want).abs().max().item():.3e}; launches {launches}")
    check(err_k <= 1.5 * err_p + 1e-3 and bool(torch.isfinite(got_k).all()),
          "UNet forward: err(kernels) <= 1.5 err(plain) + 1e-3")
    check(launches == (ATTN_PER_FORWARD, GN_PER_FORWARD),
          f"UNet forward launches {launches} == ({ATTN_PER_FORWARD}, {GN_PER_FORWARD})")
    del want, got_k, got_p

    g = gen(SEED + 5)
    x = torch.randn(B, 4, 64, 64, generator=g, device=dev)
    ts = torch.full((B,), 501, device=dev)
    ctx = torch.randn(B, 77, 768, generator=g, device=dev)

    def forward():
        return model(x, ts, ctx)

    def plain_forward():
        with plain_ops():
            return model(x, ts, ctx)

    with torch.no_grad():
        fwd_ms = {"plain": [], "kernels": []}
        for name in ("plain", "kernels", "kernels", "plain"):
            fn = forward if name == "kernels" else plain_forward
            fwd_ms[name].append(time_ms(fn, UNET_TIMED_FORWARDS))
        torch.cuda.empty_cache()
        profile = profile_by_class(forward, UNET_PROFILED_FORWARDS)
    log(f"UNet b{B} forward ms (CUDA events, {UNET_TIMED_FORWARDS} forwards, order plain, "
        f"kernels, kernels, plain; {card}): kernels {fwd_ms['kernels']}, "
        f"plain {fwd_ms['plain']}")
    log(f"UNet b{B} forward device time by class, kernel path (torch.profiler, ms per "
        f"forward over {UNET_PROFILED_FORWARDS}; wall {profile['wall_ms']:.3f} ms per forward "
        f"under the profiler): " + json.dumps(profile["classes"]))
    for name, ms in profile["top"]:
        log(f"  {ms:9.4f} ms  {name}")
    check(profile["classes"]["K1 attention"] > 0 and profile["classes"]["K3 GroupNorm"] > 0,
          "profile: the kernel path's forward ran K1 and K3 on the card")
    del x, ctx

    # ---- 5. requests ----------------------------------------------------------
    sampler = DDIM(total_steps=1000, respace_type="uniform", respace_steps=STEPS)
    g = gen(SEED + 3)
    ctx = torch.randn(B, 77, 768, generator=g, device=dev)
    noise = torch.randn(B, 4, 64, 64, generator=g, device=dev)

    def unet(xx, tt, **kw):
        return model(xx, tt, ctx)

    with torch.no_grad():
        sampler.sample(unet, noise)  # warm-up
        torch.cuda.synchronize()
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_fwd.launches_by_kernel.update(mma=0, wgmma=0)
        t0 = time.perf_counter()
        out = sampler.sample(unet, noise)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    main_launches = {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                     "K3": group_norm_silu.launches}
    k1_by_kernel = dict(flash_attention_fwd.launches_by_kernel)
    sps = B / seconds
    log(f"DDIM-{STEPS} b{B} 64x64x4: {seconds:.3f} s, {sps:.4f} samples/s ({card}); "
        f"launches {main_launches}")
    check(tuple(out.shape) == (B, 4, 64, 64) and bool(torch.isfinite(out).all()),
          "DDIM-50 output finite, [16, 4, 64, 64]")
    check(main_launches == {"K1": STEPS * ATTN_PER_FORWARD, "K2": 0,
                            "K3": STEPS * GN_PER_FORWARD},
          f"DDIM-50 launches == {STEPS} x ({ATTN_PER_FORWARD}, 0, {GN_PER_FORWARD})")
    # both K1 kernels are on the path: 10 of a forward's 32 calls are wgmma's
    wgmma_calls = sum(n for (sq, sk, d), n in ATTN_CALLS.items()
                      if select_kernel(sq, sk, d) == "wgmma")
    check(k1_by_kernel == {"wgmma": STEPS * wgmma_calls,
                           "mma": STEPS * (ATTN_PER_FORWARD - wgmma_calls)} and wgmma_calls > 0,
          f"DDIM-50 K1 launches by kernel {k1_by_kernel}: {wgmma_calls} of "
          f"{ATTN_PER_FORWARD} per forward through wgmma")

    cfg = DDIMCFG(CFG_SCALE, "context", total_steps=1000, respace_type="uniform",
                  respace_steps=STEPS)
    g = gen(SEED + 4)
    cond = torch.randn(CFG_BATCH, 77, 768, generator=g, device=dev)
    uncond = torch.randn(1, 77, 768, generator=g, device=dev).expand(CFG_BATCH, -1, -1)
    noise = torch.randn(CFG_BATCH, 4, 64, 64, generator=g, device=dev)

    def run_cfg(m):
        return cfg.sample(lambda xx, tt, context: m(xx, tt, context), noise,
                          uncond_conditioning=uncond.contiguous(),
                          model_kwargs={"context": cond}, num_steps=CFG_STEPS)

    def guided_eps(m):
        """The first step's guided noise prediction: one call on the doubled
        batch, uncond + s (cond - uncond), as DDIMCFG combines them."""
        t0 = int(cfg.sampler_tape()["t"][0])
        out = m(torch.cat([noise, noise]), torch.full((2 * CFG_BATCH,), t0, device=dev),
                torch.cat([cond, uncond]))
        eps_c, eps_u = out.float().chunk(2)
        return eps_u + CFG_SCALE * (eps_c - eps_u)

    with torch.no_grad():
        flash_attention_fwd.launches = group_norm_silu.launches = 0
        out_k = run_cfg(model)
        torch.cuda.synchronize()
        cfg_launches = (flash_attention_fwd.launches, group_norm_silu.launches)
        eps_k = guided_eps(model)
        with plain_ops():
            out_p, eps_p = run_cfg(model), guided_eps(model)
            out_f, eps_f = run_cfg(ref_model), guided_eps(ref_model)
    err_k, err_p = rel_err(eps_k, eps_f), rel_err(eps_p, eps_f)
    log(f"DDIMCFG s={CFG_SCALE} b{CFG_BATCH} first-step guided eps: rel L2 err vs f32 plain: "
        f"kernels {err_k:.3e}, plain bf16 {err_p:.3e}")
    check(bool(torch.isfinite(eps_k).all()) and err_k <= 1.5 * err_p,
          "DDIMCFG guided eps: finite, err(kernels) <= 1.5 err(plain)")
    err_k, err_p = rel_err(out_k, out_f), rel_err(out_p, out_f)
    log(f"DDIMCFG s={CFG_SCALE} b{CFG_BATCH} {CFG_STEPS} steps: rel L2 err vs f32 plain: "
        f"kernels {err_k:.3e}, plain bf16 {err_p:.3e}; launches {cfg_launches}")
    check(bool(torch.isfinite(out_k).all()) and err_k <= 1.5 * err_p,
          "DDIMCFG sample: finite, err(kernels) <= 1.5 err(plain)")
    check(cfg_launches == (CFG_STEPS * ATTN_PER_FORWARD, CFG_STEPS * GN_PER_FORWARD),
          f"DDIMCFG launches == {CFG_STEPS} x ({ATTN_PER_FORWARD}, {GN_PER_FORWARD})")
    del model, out, out_k, out_p, out_f
    torch.cuda.empty_cache()

    # ---- 6. K2 --------------------------------------------------------------
    k2 = phase_k2(dev, check, time_ms, host_us, gen)
    k2_by_kernel = k2.pop("by_kernel")

    # ---- 7. training -----------------------------------------------------------
    train = phase_train(dev, check, gen, ref_model, card)
    check("jax" not in sys.modules, "no JAX imported")

    if failures:
        log(f"chip_smoke: {len(failures)} check(s) failed: {failures}")
        return 1
    by_path = {name: {"ddim50": main_launches[name],
                      f"train{TRAIN_TIMED_STEPS}": train["launches"][name]}
               for name in ("K1", "K2", "K3")}
    def entry(name, source, replaces, launches, per, r):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[0], "launches_by_path": launches[1],
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                # what bounds the larger share of the summed bound
                "bound_by": max(r["bound_ms_by"], key=r["bound_ms_by"].get),
                "bound_ms_by": r["bound_ms_by"],
                "library_ms": r["library_ms"], "host_us": r["host_us"], "timing": per}

    k2["err"] = k2.pop("max_abs_err")
    log(json.dumps({"kernels": [
        dict(entry("flash_attn_fwd", "dmtpu_torch/csrc/flash_attn_fwd.cu",
                   "dmtpu/ops/flash_small_d.py:50", (main_launches["K1"], by_path["K1"]),
                   f"per b{B} UNet forward: sum over its {ATTN_PER_FORWARD} attention calls", k1),
             other_sources=["dmtpu_torch/csrc/flash_attn_fwd_mma.cu",
                            "dmtpu_torch/csrc/hopper.cuh"],
             launches_by_kernel=k1_by_kernel),
        dict(entry("flash_attn_bwd", "dmtpu_torch/csrc/flash_attn_bwd.cu",
                   "dmtpu/ops/flash_small_d.py:118", (train["launches"]["K2"], by_path["K2"]),
                   f"per b{B} train step: sum over its {ATTN_PER_FORWARD} attention backwards",
                   k2),
             other_sources=["dmtpu_torch/csrc/flash_attn_bwd_mma.cu",
                            "dmtpu_torch/csrc/hopper.cuh"],
             launches_by_kernel=train["k2_by_kernel"], ms_by_kernel=k2_by_kernel),
        entry("group_norm_silu", "dmtpu_torch/csrc/group_norm_silu.cu",
              "dmtpu/ops/groupnorm.py:44", (main_launches["K3"], by_path["K3"]),
              f"per b{B} UNet forward: sum over its {GN_PER_FORWARD} GroupNorm calls", k3),
    ], "ddim50_b16_samples_per_s": sps, "unet_b16_forward_ms": fwd_ms,
        "train_b16": train["metrics"], "card": card}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def not_the_slower(by_kernel: dict, chosen: str, ms: float, host_us: float) -> bool:
    """The dispatched kernel's best time is within 25% of every other
    kernel's best.  Held only where it can be told: a row within the host's
    launch time, or with a time under 0.05 ms (there two timings of one
    kernel differ by half: 0.018 and 0.028 ms in one run), says nothing about
    the kernels and passes."""
    best = {name: min(times) for name, times in by_kernel.items()}
    if ms <= 1.2 * host_us / 1e3 or min(best.values()) < 0.05:
        return True
    return all(best[chosen] <= 1.25 * t for t in best.values())


@contextlib.contextmanager
def forced_plan(module, how: dict):
    """Within the block, ``module.plan`` answers ``how`` whatever it is asked."""
    real = module.plan
    module.plan = lambda *args: how
    try:
        yield
    finally:
        module.plan = real


def phase_k2(dev, check, time_ms, host_us, gen) -> dict:
    """K2 at every attention shape of the path, b16 h8 bf16, from K1's outputs
    and a random dO: dq, dk and dv of every K2 kernel that takes the shape
    against K2's plain version and against f32 autograd through ``mha`` on the
    same bf16 values; the kernels' times in turns, and the dispatch's choice."""
    import torch
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.attention import mha
    from dmtpu_torch.ops.flash_attention import (
        WGMMA_BWD_KEY_TILE,
        bwd_kernels_for,
        flash_attention_backward_reference,
        flash_attention_bwd,
        flash_attention_fwd,
        select_bwd_kernel,
    )

    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, host_us=0.0)
    bound_ms_by = {"bytes": 0.0, "operations": 0.0}
    by_kernel = {"mma": 0.0, "wgmma": 0.0}  # ms per train step through each kernel
    worst = 0.0
    g = gen(SEED + 6)
    for (sq, sk, d), calls in ATTN_CALLS.items():
        q, k, v, do = (torch.randn(B, s, 8, d, generator=g, device=dev).bfloat16()
                       for s in (sq, sk, sk, sq))
        o, lse = flash_attention_fwd(q, k, v)
        names = bwd_kernels_for(d)
        chosen = select_bwd_kernel(sq, sk, d)
        plain = flash_attention_backward_reference(q, k, v, o, lse, do)
        leaves = [x.float().requires_grad_() for x in (q, k, v)]
        mha(*leaves).backward(do.float())
        row = dict(b=B, h=8, sq=sq, sk=sk, d=d, calls=calls, kernel=chosen)
        # both versions round P and dS to bf16, from f32 values that differ in
        # their last bits (exp2 vs exp, summation order, dq's f32 adds in
        # run-to-run order): single elements may land one bf16 step apart, so
        # 1e-2 of max|grad| and 1e-2 relative L2; a skipped or doubled tile
        # moves the L2 error by 1/sqrt(tiles), 12% at S=4096.  Against f32
        # autograd 2e-2: the kernel rounds P, dS and its outputs to bf16
        for kernel in names:
            got = flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
            torch.cuda.synchronize()
            ok = all(bool(torch.isfinite(x).all()) and x.dtype == torch.bfloat16 for x in got)
            errs = {}
            for name, a, want, leaf in zip(("dq", "dk", "dv"), got, plain, leaves):
                a, want, f32 = a.float(), want.float(), leaf.grad
                err = (a - want).abs().max().item()
                rel = ((a - want).norm() / want.norm()).item()
                rel_f32 = ((a - f32).norm() / f32.norm()).item()
                errs[f"{name}_max_abs_err"], errs[f"{name}_rel_l2"] = err, rel
                errs[f"{name}_rel_l2_vs_f32_mha"] = rel_f32
                ok = ok and err <= 1e-2 * want.abs().max().item() and rel <= 1e-2 and \
                    rel_f32 <= 2e-2 and \
                    (a - f32).abs().max().item() <= 2e-2 * f32.abs().max().item()
            check(ok, f"K2[{kernel}] bf16 b{B} h8 S_q={sq} S_k={sk} d={d}: vs plain and vs f32 "
                      f"mha autograd")
            if kernel == "wgmma" and sk <= WGMMA_BWD_KEY_TILE:
                # one key tile: the CTA writes dq itself, with no adds across CTAs
                again = flash_attention_bwd(q, k, v, o, lse, do, kernel=kernel)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"K2[{kernel}] S_q={sq} S_k={sk} d={d}: two runs agree bit for bit")
                del again
            if kernel == chosen:
                row.update(errs)
                worst = max(worst, *(errs[f"{name}_max_abs_err"] for name in ("dq", "dk", "dv")))
            del got
        del plain, leaves
        torch.cuda.empty_cache()
        ms_by_kernel = {name: [] for name in names}
        for name in names + names[::-1]:
            ms_by_kernel[name].append(
                time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, kernel=name), 10))
        row["ms"] = sum(ms_by_kernel[chosen]) / len(ms_by_kernel[chosen])
        row["ms_by_kernel"] = ms_by_kernel
        row["plain_ms"] = time_ms(
            lambda: flash_attention_backward_reference(q, k, v, o, lse, do), 3)
        # the library's backward: forward and backward of one SDPA call on
        # [B, H, S, D] views of the same values, less the forward alone
        lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ldo = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            out = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)
            lq.grad = lk.grad = lv.grad = None
            out.backward(ldo)

        def sdpa_fwd():
            with torch.no_grad():
                torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)

        row["library_ms"] = time_ms(sdpa_fwd_bwd, 10) - time_ms(sdpa_fwd, 10)
        row["host_us"] = host_us(lambda: flash_attention_bwd(q, k, v, o, lse, do), 50)
        row["bound_ms"], row["bound_by"] = roofline.bound_ms(
            *roofline.attention_bwd_work(B, 8, sq, sk, d))
        row["host_bound"] = row["ms"] <= 1.2 * row["host_us"] / 1e3
        for key in totals:
            totals[key] += calls * row[key]
        bound_ms_by[row["bound_by"]] += calls * row["bound_ms"]
        by_kernel[chosen] += calls * row["ms"]
        log("K2", json.dumps(row))
        check(not_the_slower(ms_by_kernel, chosen, row["ms"], row["host_us"]),
              f"K2 dispatch S_q={sq} S_k={sk} d={d}: {chosen} is not the slower kernel")
        del q, k, v, do, o, lse, lq, lk, lv, ldo
        torch.cuda.empty_cache()
    log(f"K2 per b{B} train step ({ATTN_PER_FORWARD} calls): " + json.dumps(totals)
        + "; by kernel: " + json.dumps(by_kernel))
    return dict(totals, max_abs_err=worst, bound_ms_by=bound_ms_by, by_kernel=by_kernel)


def per_step_launches(model) -> dict:
    """Kernel launches of one train step, read off the module tree: K1 once
    per attention in the forward and again in the recompute of a
    rematerialised block; K2 once per attention; K3 once per GroupNorm in the
    forward and again for those inside rematerialised blocks (the GroupNorm
    backward runs the plain version, no kernel)."""
    from dmtpu_torch.models.adm import GroupNorm32, ResBlock
    from dmtpu_torch.models.stablediffusion.attention import CrossAttention, SpatialTransformer

    def count(kind, root):
        return sum(isinstance(m, kind) for m in root.modules())

    remat_roots = [m for m in model.modules() if isinstance(m, (ResBlock, SpatialTransformer))]
    attn = count(CrossAttention, model)
    attn_remat = sum(count(CrossAttention, r) for r in remat_roots) if model.use_checkpoint else 0
    gn = count(GroupNorm32, model)
    gn_remat = sum(count(GroupNorm32, r) for r in remat_roots) if model.use_checkpoint else 0
    return {"K1": attn + attn_remat, "K2": attn, "K3": gn + gn_remat}


def phase_train(dev, check, gen, ref_model, card) -> dict:
    """Phase 7 (see the module docstring).  ``ref_model`` is the f32 UNet
    whose random weights every run here starts from."""
    import torch
    from dmtpu_torch.diffusions import DDPM
    from dmtpu_torch.models.stablediffusion import SDUNetModel
    from dmtpu_torch.ops import plain_ops
    from dmtpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        select_bwd_kernel,
    )
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    from dmtpu_torch.parallel import TrainState, make_diffusion_loss_fn, make_train_step
    from dmtpu_torch.utils.optim import adafactor

    def counts():
        return {"K1": flash_attention_fwd.launches, "K2": flash_attention_bwd.launches,
                "K3": group_norm_silu.launches}

    def zero_counts():
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        group_norm_silu.launches = 0
        flash_attention_bwd.launches_by_kernel.update(mma=0, wgmma=0)

    # K2 launches of one step by kernel, as the dispatch sends the path's shapes
    k2_per_step = {"mma": 0, "wgmma": 0}
    for (sq, sk, d), calls in ATTN_CALLS.items():
        k2_per_step[select_bwd_kernel(sq, sk, d)] += calls

    init = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    model = SDUNetModel(**SD15, torso_dtype=torch.bfloat16, use_checkpoint=True,
                        device=dev).train()
    model.load_state_dict(init)
    ref_model.train()
    want_per_step = per_step_launches(model)
    log(f"train: launches per step from the module tree (remat on): {want_per_step}")
    diffuser = DDPM(total_steps=1000)

    def fixed_loss(m):
        def loss_fn(batch, generator):
            return diffuser.loss_func(m, batch["image"], batch["t"], eps=batch["eps"],
                                      model_kwargs={"context": batch["context"]})
        return loss_fn

    g = gen(SEED + 7)
    fixed = {"image": torch.randn(TRAIN_CHECK_BATCH, 4, 64, 64, generator=g, device=dev),
             "eps": torch.randn(TRAIN_CHECK_BATCH, 4, 64, 64, generator=g, device=dev),
             "t": torch.tensor([999, 421], device=dev)[:TRAIN_CHECK_BATCH],
             "context": torch.randn(TRAIN_CHECK_BATCH, 77, 768, generator=g, device=dev)}

    # (a) loss and gradient at b2 against f32
    def loss_and_grads(m, plain: bool):
        m.zero_grad(set_to_none=True)
        with plain_ops() if plain else contextlib.nullcontext():
            loss = fixed_loss(m)(fixed, None)
            loss.backward()
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()}

    loss_f, grads_f = loss_and_grads(ref_model, plain=True)
    grads_f = {n: gr.clone() for n, gr in grads_f.items()}
    ref_model.zero_grad(set_to_none=True)
    zero_counts()
    loss_k, grads_k = loss_and_grads(model, plain=False)
    torch.cuda.synchronize()
    check_launches = counts()
    check_k2 = dict(flash_attention_bwd.launches_by_kernel)
    err_k = (sum((grads_k[n] - grads_f[n]).square().sum() for n in grads_f).sqrt()
             / sum(gr.square().sum() for gr in grads_f.values()).sqrt()).item()
    lerr_k = abs(loss_k.item() - loss_f.item()) / abs(loss_f.item())
    loss_p, grads_p = loss_and_grads(model, plain=True)
    err_p = (sum((grads_p[n] - grads_f[n]).square().sum() for n in grads_f).sqrt()
             / sum(gr.square().sum() for gr in grads_f.values()).sqrt()).item()
    lerr_p = abs(loss_p.item() - loss_f.item()) / abs(loss_f.item())
    log(f"train b{TRAIN_CHECK_BATCH} loss: f32 {loss_f.item():.6f}, kernels {loss_k.item():.6f}, "
        f"plain bf16 {loss_p.item():.6f}; rel err vs f32: kernels {lerr_k:.3e}, plain {lerr_p:.3e}")
    log(f"train b{TRAIN_CHECK_BATCH} gradient ({len(grads_f)} tensors): rel L2 err vs f32 plain: "
        f"kernels {err_k:.3e}, plain bf16 {err_p:.3e}; launches {check_launches}")
    check(bool(torch.isfinite(loss_k)) and lerr_k <= 1.5 * lerr_p + 1e-3,
          "train loss: err(kernels) <= 1.5 err(plain) + 1e-3")
    check(err_k <= 1.5 * err_p + 1e-3, "train gradient: err(kernels) <= 1.5 err(plain) + 1e-3")
    # (b) exact launches of one forward + backward
    check(check_launches == want_per_step,
          f"train forward+backward launches {check_launches} == {want_per_step}")
    check(check_k2 == k2_per_step and k2_per_step["wgmma"] > 0,
          f"train forward+backward K2 launches by kernel {check_k2} == {k2_per_step}")
    del grads_f, grads_k, grads_p
    ref_model.zero_grad(set_to_none=True)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    def fresh_state():
        model.load_state_dict(init)
        return TrainState.create(model, adafactor(model.parameters(), lr=TRAIN_LR),
                                 ema_decay=EMA_DECAY, ema_gradual=True,
                                 ema_dtype=torch.bfloat16)

    # (d) learning on one fixed batch.  The kernel path trains, and before each
    # of its steps the plain bf16 path's loss is taken at the same weights.
    # The two are not trained apart: each adafactor step (at first a step of
    # lr in the sign of every gradient) compounds their rounding differences,
    # so their losses part by more than either path's error
    step = make_train_step(fixed_loss(model), clip_grad_norm=TRAIN_CLIP)
    lk, ls = [], []
    state = fresh_state()
    for _ in range(LEARN_STEPS):
        with torch.no_grad(), plain_ops():
            ls.append(fixed_loss(model)(fixed, None).item())
        lk.append(step(state, fixed)["loss"].item())
    del state
    same = max(abs(a - b) / abs(b) for a, b in zip(lk, ls))
    log(f"train b{TRAIN_CHECK_BATCH} fixed batch, {LEARN_STEPS} steps, loss: kernels {lk}; "
        f"plain at the same weights {ls} (worst rel. diff {same:.3e})")
    check(all(map(math.isfinite, lk)) and lk[-1] < lk[0], "train: the kernel path's loss falls")
    # at the same weights the two paths differ only in rounding (at most
    # 5.9e-5 over 10 steps on the card); 1e-3 is the floor of (a)
    check(same <= 1e-3, "train: at the kernel path's weights of each step, its loss is within "
                        "1e-3 of the plain path's")
    torch.cuda.empty_cache()

    # (c) timing at b16 through the main path's own loss (random t and eps)
    g = gen(SEED + 8)
    batch = {"image": torch.randn(B, 4, 64, 64, generator=g, device=dev),
             "context": torch.randn(B, 77, 768, generator=g, device=dev)}
    state = fresh_state()
    step = make_train_step(make_diffusion_loss_fn(diffuser, model, 1000),
                           clip_grad_norm=TRAIN_CLIP)
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    history = [step(state, batch) for _ in range(TRAIN_TIMED_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts()
    k2_by_kernel = dict(flash_attention_bwd.launches_by_kernel)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in history]
    norms = [m["grad_norm"].item() for m in history]
    metrics = {"imgs_per_s": B * TRAIN_TIMED_STEPS / seconds,
               "ms_per_step": 1e3 * seconds / TRAIN_TIMED_STEPS,
               "peak_bytes": peak, "batch": B, "steps": TRAIN_TIMED_STEPS,
               "launches_per_step": want_per_step, "k2_launches_per_step": k2_per_step}
    log(f"train b{B}: {TRAIN_TIMED_STEPS} steps in {seconds:.3f} s, {metrics['imgs_per_s']:.4f} "
        f"imgs/s, {metrics['ms_per_step']:.3f} ms/step, peak {peak / 2**30:.3f} GiB ({card}); "
        f"launches {launches}; losses {losses}; grad norms {norms}")
    check(all(map(math.isfinite, losses + norms)), "train b16: finite losses and grad norms")
    check(launches == {k: TRAIN_TIMED_STEPS * n for k, n in want_per_step.items()},
          f"train b{B} launches == {TRAIN_TIMED_STEPS} x {want_per_step}")
    check(k2_by_kernel == {k: TRAIN_TIMED_STEPS * n for k, n in k2_per_step.items()},
          f"train b{B} K2 launches by kernel {k2_by_kernel} == {TRAIN_TIMED_STEPS} x "
          f"{k2_per_step}")
    check(state.ema.num_updates == TRAIN_TIMED_STEPS + 1
          and all(s.dtype == torch.bfloat16 for s in state.ema.shadow.values()),
          "train: EMA updated each step, bf16 shadow")
    torch.cuda.empty_cache()
    profile = profile_by_class(lambda: step(state, batch), 2)
    log(f"train b{B} step device time by class (torch.profiler, ms per step over 2; wall "
        f"{profile['wall_ms']:.3f} ms per step under the profiler): "
        + json.dumps(profile["classes"]) + "; annotated ranges: " + json.dumps(profile["ranges"]))
    for name, ms in profile["top"]:
        log(f"  {ms:9.4f} ms  {name}")
    metrics["profile_ms"] = dict(profile["classes"], wall=profile["wall_ms"], **profile["ranges"])
    return {"launches": launches, "k2_by_kernel": k2_by_kernel, "metrics": metrics}


# kernel-name fragments -> class, first match wins
KERNEL_CLASSES = (
    ("flash_fwd", "K1 attention"), ("flash_bwd", "K2 attention backward"),
    ("group_norm", "K3 GroupNorm"),
    ("at::native", "PyTorch elementwise and reductions"),
    ("nchwToNhwc", "cuDNN convolutions"), ("nhwcToNchw", "cuDNN convolutions"),
    ("fprop", "cuDNN convolutions"), ("dgrad", "cuDNN convolutions"),
    ("wgrad", "cuDNN convolutions"), ("conv", "cuDNN convolutions"),
    ("gemm", "cuBLAS GEMMs"), ("nvjet", "cuBLAS GEMMs"),
)


def profile_by_class(fn, calls: int) -> dict:
    """Device time per call of ``fn`` by class of kernel (``KERNEL_CLASSES``,
    else "other"), the twelve costliest kernels, the device span of each
    annotated range (such as ``Optimizer.step``; not a kernel, so not in the
    classes) and the wall time per call, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    classes = {name: 0.0 for _, name in KERNEL_CLASSES}
    classes["other"] = 0.0
    kernels, ranges = [], {}
    for row in prof.key_averages():
        if row.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = row.self_device_time_total / 1e3 / calls
        if getattr(row, "is_user_annotation", False):
            ranges[row.key] = ms
            continue
        cls = next((c for frag, c in KERNEL_CLASSES if frag in row.key), "other")
        classes[cls] += ms
        kernels.append((row.key[:150], ms))
    classes["total"] = sum(classes.values())
    return {"classes": classes, "top": sorted(kernels, key=lambda kv: -kv[1])[:12],
            "ranges": ranges, "wall_ms": wall_ms}


def init_random_(model, generator) -> None:
    """Seeded random weights: N(0, 1/fan_in) for convolutions and dense
    layers, norm scales near 1, small biases.  The layers the model zero-
    initialises (``out_layers.3``, ``proj_out``, ``out.2``) get small
    non-zero weights, or the output would not depend on the blocks they
    close."""
    import torch

    def zero_init(name: str) -> bool:
        return "out_layers.3." in name or "proj_out." in name or name.startswith("out.2.")

    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=generator, device=p.device)
            if name.endswith("bias"):
                p.copy_(0.02 * noise)
            elif p.dim() == 1:  # GroupNorm / LayerNorm scale
                p.copy_(1 + 0.05 * noise)
            else:
                std = p[0].numel() ** -0.5
                if zero_init(name):
                    std *= 0.2
                p.copy_(std * noise)


if __name__ == "__main__":
    sys.exit(main())
