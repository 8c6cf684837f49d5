"""Development probe of K3 (GroupNorm + SiLU) on one CUDA card: its contiguous
NCHW route and its channels-last small-group route.

    python -m dmtpu_torch.dev.k3_probe            # check, time, variants
    python -m dmtpu_torch.dev.k3_probe time       # one phase
    python -m dmtpu_torch.dev.k3_probe time cl    # its channels-last part alone

- ``check``: builds the kernels, prints what ``ptxas`` said of the "team"
  kernel's instances (registers, spills), and holds both NCHW kernels
  ("team" and "nchw") against K3's plain version, two runs bit for bit, at
  shapes that take each of the team kernel's forms: a warp a slab (the pixel
  UNets' small maps), a CTA a slab, teams of CTAs (the VAE's decodes),
  shares of more than one batch (re-read from the L2 cache), slabs that do
  not split evenly, a batch of one, a large mean; f32 and bf16, SiLU on
  and off.
- ``time``: at every contiguous NCHW GroupNorm shape of the repository's
  paths (the SD1.5 VAE decode at 512x512 b16, DiT's at 256x256 b32, SD3's
  and SDXL's at 1024x1024 b2 and b1, ADM-256 b16, CelebA-HQ b16, the CIFAR
  UNet b500), the device time (``torch.profiler``) of "team", of "nchw", of
  ``F.group_norm`` + ``F.silu`` and of ``x.clone()`` (one read and one write
  of x: what the memory system gives), beside the bound
  (``ops/roofline.py``); each path's sum over one call's GroupNorms.
- ``variants``: the team kernel at other launch shapes than the plan's
  (team sizes, CTAs in all) at the SD1.5 decode's largest shape, SDXL's and
  the CIFAR UNet's, by device time: what the plan's choice is read off.

Each phase also takes the channels-last calls that the "rows" kernel does
not take (``CL_PATHS``: the small-group GroupNorms of the CIFAR-10 UNet's
reconstruction at b8 and b500, CelebA-HQ's at b16 and the MNIST UNet's at
b500, as ``sample_uncond --mode reconstruction`` hands them to K3): ``check``
holds "chunks" (as planned, and in its other form: held or streamed) and
"groups" against the plain version, two runs bit for bit, the layout kept,
there and at odd shapes (1, 2, 3 and 6 channels a group with C % 8 != 0, a
large mean); ``time`` gives each path's device time of "groups", of
"chunks" as planned and in its other form (the streamed form is "rows"
widened to chunks of several groups), of the library call, of
``x.clone()`` and the bound; ``variants`` the chunks kernel at every cluster
size in both forms at each shape of those paths.

With no argument each phase runs in a process of its own with a time limit: a
team whose CTAs are not all resident would otherwise wait for ever.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

from dmtpu_torch.dev.k2_probe import _card, _device_ms

ROOT = Path(__file__).resolve().parents[2]
PHASE_LIMITS = {"check": 300, "time": 600, "variants": 300}  # seconds

# the SD1.5 VAE decoder at 512x512 (chip_smoke.VAE_DECODE_GN): (C, H*W, silu): calls
VAE_DECODE = {(512, 4096, True): 10, (512, 4096, False): 1, (512, 16384, True): 6,
              (512, 65536, True): 1, (256, 65536, True): 5, (256, 262144, True): 1,
              (128, 262144, True): 6}
# the pixel UNets' NCHW GroupNorms of one call (bf16 torso; the f32 output
# norm), read off their module trees: (C, H*W, dtype, silu): calls
ADM256 = {(256, 65536, "bf16", True): 3, (256, 65536, "bf16", False): 6,
          (256, 16384, "bf16", False): 6, (256, 16384, "bf16", True): 4,
          (256, 4096, "bf16", False): 1, (256, 4096, "bf16", True): 1,
          (512, 4096, "bf16", False): 6, (512, 4096, "bf16", True): 3,
          (512, 1024, "bf16", False): 11, (512, 1024, "bf16", True): 4,
          (512, 256, "bf16", False): 1, (512, 256, "bf16", True): 1,
          (1024, 256, "bf16", False): 11, (1024, 256, "bf16", True): 3,
          (1024, 64, "bf16", False): 14, (1024, 64, "bf16", True): 5,
          (2048, 64, "bf16", True): 3, (2048, 256, "bf16", True): 2,
          (1536, 256, "bf16", True): 1, (1024, 1024, "bf16", False): 1,
          (1536, 1024, "bf16", True): 1, (1024, 1024, "bf16", True): 2,
          (1024, 4096, "bf16", True): 2, (768, 4096, "bf16", True): 1,
          (512, 16384, "bf16", False): 1, (768, 16384, "bf16", True): 1,
          (512, 16384, "bf16", True): 2, (512, 65536, "bf16", True): 3,
          (256, 65536, "f32", True): 1}
CELEBAHQ = {(128, 65536, "bf16", True): 7, (128, 16384, "bf16", True): 7,
            (128, 4096, "bf16", True): 1, (256, 4096, "bf16", True): 6,
            (256, 1024, "bf16", True): 7, (256, 256, "bf16", True): 1,
            (512, 256, "bf16", True): 5, (512, 256, "bf16", False): 5,
            (512, 64, "bf16", True): 10, (512, 64, "bf16", False): 1,
            (1024, 64, "bf16", True): 3, (1024, 256, "bf16", True): 1,
            (768, 256, "bf16", True): 1, (768, 1024, "bf16", True): 1,
            (512, 1024, "bf16", True): 2, (512, 4096, "bf16", True): 2,
            (384, 4096, "bf16", True): 1, (384, 16384, "bf16", True): 1,
            (256, 16384, "bf16", True): 2, (256, 65536, "bf16", True): 3,
            (128, 65536, "f32", True): 1}
CIFAR = {(128, 1024, "bf16", True): 7, (128, 256, "bf16", True): 1,
         (256, 256, "bf16", True): 5, (256, 256, "bf16", False): 5,
         (256, 64, "bf16", True): 7, (256, 16, "bf16", True): 10,
         (256, 16, "bf16", False): 1, (512, 16, "bf16", True): 3, (512, 64, "bf16", True): 3,
         (512, 256, "bf16", True): 1, (384, 256, "bf16", True): 1,
         (384, 1024, "bf16", True): 1, (256, 1024, "bf16", True): 2,
         (128, 1024, "f32", True): 1}


def _vae(scale: int) -> dict:
    return {(c, hw * scale, "f32", silu): n for (c, hw, silu), n in VAE_DECODE.items()}


# label: (batch, eps, {(C, H*W, dtype, silu): calls a call})
PATHS = {
    "sd15_decode_b16_512": (16, 1e-6, _vae(1)),
    "dit_decode_b32_256": (32, 1e-6, {(c, hw // 4, d, s): n for (c, hw, d, s), n in _vae(1).items()}),
    "sd3_decode_b2_1024": (2, 1e-6, _vae(4)),
    "sdxl_decode_b1_1024": (1, 1e-6, _vae(4)),
    "adm256_b16": (16, 1e-5, ADM256),
    "celebahq_b16": (16, 1e-5, CELEBAHQ),
    "cifar_b500": (500, 1e-5, CIFAR),
}

# The channels-last GroupNorms that "rows" does not take (fewer than 8
# channels a group), read off the UNets' module trees: (C, H*W, dtype, silu):
# calls a call.  The reconstruction's input batch is channels-last in memory
# (``sample_uncond``'s ``permute``) and cuDNN keeps the layout, so every one
# of them reaches K3 channels-last there.
CIFAR_SMALL = {(128, 1024, "bf16", True): 7, (128, 1024, "f32", True): 1,
               (128, 256, "bf16", True): 1}
CELEBAHQ_SMALL = {(128, 65536, "bf16", True): 7, (128, 65536, "f32", True): 1,
                  (128, 16384, "bf16", True): 7, (128, 4096, "bf16", True): 1}
MNIST_SMALL = {(64, 256, "bf16", True): 1, (64, 1024, "bf16", True): 7,
               (64, 1024, "f32", True): 1, (128, 16, "bf16", False): 1,
               (128, 16, "bf16", True): 11, (128, 64, "bf16", True): 7,
               (128, 256, "bf16", False): 5, (128, 256, "bf16", True): 6,
               (128, 1024, "bf16", True): 2, (192, 256, "bf16", True): 1,
               (192, 1024, "bf16", True): 1}
# label: (batch, eps, table), 32 groups
CL_PATHS = {
    "cifar_recon_b8": (8, 1e-5, CIFAR_SMALL),
    "cifar_recon_b500": (500, 1e-5, CIFAR_SMALL),
    "celebahq_recon_b16": (16, 1e-5, CELEBAHQ_SMALL),
    "mnist_b500_cl": (500, 1e-5, MNIST_SMALL),
}
# the SD1.5 UNet's channels-last shapes, which "rows" takes: n, C, H*W
ROWS_SHAPES = [(16, 320, 4096), (16, 640, 1024), (16, 1280, 256), (16, 2560, 64),
               (32, 320, 4096), (32, 960, 1024)]
# channels-last shapes off the paths: n, C, H*W, dtype, silu, groups (1, 2,
# 3 and 6 channels a group with C % 8 != 0; H*W*C % 8 != 0 in three)
CL_ODD_SHAPES = [(2, 33, 64, "f32", True, 33), (3, 66, 49, "bf16", False, 33),
                 (2, 99, 25, "f32", True, 33), (2, 198, 36, "bf16", True, 33),
                 (4, 36, 15, "f32", False, 6), (2, 12, 9, "bf16", True, 2)]

# n, C, H*W, dtype, silu, groups
CHECK_SHAPES = [
    (2, 256, 16, "bf16", True, 32), (5, 512, 64, "f32", False, 32), (3, 256, 256, "bf16", True, 32),
    (4, 128, 1024, "f32", True, 32), (2, 1536, 256, "bf16", True, 32), (2, 512, 4096, "f32", True, 32),
    (2, 256, 65536, "f32", False, 32), (1, 128, 262144, "f32", True, 32),
    (1, 256, 1048576, "f32", True, 32), (2, 96, 200, "f32", True, 8), (3, 64, 24, "bf16", False, 32),
    (1, 512, 16384, "bf16", True, 32), (16, 128, 65536, "bf16", True, 32)]
# forced (form, team, CTAs) at (n, C, H*W, dtype): shares of several slots
# (streamed again), teams that do not divide the slab evenly, fewer CTAs than
# slabs in each form
FORCED = [((2, 128, 262144, "f32"), ("stream", 8, 16)), ((2, 128, 262144, "f32"), ("stream", 3, 9)),
          ((3, 512, 4096, "bf16"), ("stream", 1, 7)), ((2, 256, 65536, "f32"), ("stream", 37, 74)),
          ((2, 128, 2048, "f32"), ("cta", 1, 5)), ((5, 256, 64, "f32"), ("warp", 0, 3))]
VARIANT_SHAPES = [(16, 128, 262144, "f32"), (16, 256, 262144, "f32"), (1, 128, 1048576, "f32"),
                  (16, 256, 65536, "bf16"), (500, 128, 1024, "bf16"), (16, 512, 4096, "f32"),
                  (16, 512, 16384, "f32")]


def _inputs(torch, gen, n, c, hw, dname, channels_last=False):
    dtype = torch.bfloat16 if dname == "bf16" else torch.float32
    side = max(f for f in range(1, int(hw ** 0.5) + 1) if hw % f == 0)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = (torch.randn(n, c, side, hw // side, generator=gen, device="cuda") * 2 + 0.5).to(
        dtype=dtype, memory_format=fmt)
    w = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, w, 0.1 * torch.randn(c, generator=gen, device="cuda")


def _close(torch, y, want) -> tuple[bool, float]:
    """chip_smoke's K3 tolerance: summation order in f32; one bf16 step in bf16."""
    tol = 1e-4 if y.dtype == torch.float32 else 2.0 ** -7
    diff = (y.float() - want.float()).abs()
    return bool((diff <= tol * want.float().abs() + 1e-4).all()), diff.max().item()


def _forced(torch, x, w, b, groups, eps, silu, form, team, ctas):
    from dmtpu_torch.ops import _build
    from dmtpu_torch.ops.groupnorm import TEAM_FORMS, _team_scratch
    n, c, h, wd = x.shape
    y = torch.empty_like(x)
    scratch, epoch = _team_scratch(x.get_device())
    err = _build.library().dmtpu_group_norm_team(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, c, h * wd, groups, eps,
        int(silu), int(x.dtype == torch.bfloat16), TEAM_FORMS[form], team, ctas,
        scratch.data_ptr(), epoch,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "group_norm_team launch")
    return y


def _chunks(torch, x, w, b, groups, eps, silu, held=None, cluster=None, periods=None):
    """The chunks kernel at a forced form (``held``), cluster size and
    periods a pass (CTA size)."""
    from dmtpu_torch.ops import _build
    from dmtpu_torch.ops.groupnorm import chunks_plan
    n, c, h, wd = x.shape
    how = chunks_plan(c, h * wd, groups, x.element_size(), n, held, cluster, periods)
    y = torch.empty_like(x)
    err = _build.library().dmtpu_group_norm_chunks(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, c, h * wd, groups, eps,
        int(silu), int(x.dtype == torch.bfloat16), int(how["held"]), how["cluster"],
        how["periods"], how["threads"], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "group_norm_chunks launch")
    return y


def _other_form(c, hw, groups, esize, n):
    """The chunks kernel's form the plan does not pick, where the kernel
    takes it (held needs H*W*C % 8 == 0 and a share that fits), else None."""
    from dmtpu_torch.ops.groupnorm import SMEM_LIMIT, chunks_plan
    held = not chunks_plan(c, hw, groups, esize, n)["held"]
    if held and ((hw * c) % 8 or chunks_plan(c, hw, groups, esize, n, True, 8)["smem"]
                 > SMEM_LIMIT):
        return None
    return held


def check_channels_last(torch, gen) -> int:
    """"chunks" (as planned and in its other form) and "groups" against the
    plain version at the channels-last paths' shapes and at odd ones; two
    runs bit for bit, the layout kept."""
    from dmtpu_torch.ops.groupnorm import (
        group_norm_silu,
        group_norm_silu_reference,
        kernels_for,
        plan,
    )
    shapes = sorted({(min(n, 16), c, hw, dname, silu, 32)
                     for n, _, table in CL_PATHS.values() for c, hw, dname, silu in table})
    bad = 0
    for n, c, hw, dname, silu, groups in shapes + CL_ODD_SHAPES:
        x, w, b = _inputs(torch, gen, n, c, hw, dname, channels_last=True)
        want = group_norm_silu_reference(x, w, b, groups, 1e-5, silu)
        how = plan(c, hw, groups, x.element_size(), True, n)
        runs = {name: (lambda name=name: group_norm_silu(x, w, b, groups, 1e-5, silu,
                                                         kernel=name))
                for name in kernels_for(c, hw, groups, True)}
        other = _other_form(c, hw, groups, x.element_size(), n)
        if other is not None:
            runs["chunks " + ("held" if other else "streamed")] = \
                lambda: _chunks(torch, x, w, b, groups, 1e-5, silu, other)
        line = f"channels-last b{n} C={c} HW={hw} G={groups} {dname} silu={silu} plan {how}:"
        for name, run in runs.items():
            y, again = run(), run()
            torch.cuda.synchronize()
            ok, err = _close(torch, y, want)
            same = torch.equal(y, again) and y.is_contiguous(memory_format=torch.channels_last)
            bad += not (ok and same)
            line += f" {name} max err {err:.2e} same bits {same} {'ok' if ok and same else 'BAD'};"
        print(line, flush=True)
    # mean >> std through both forms of the chunks kernel (bound as in the card tests)
    x, w, b = _inputs(torch, gen, 2, 128, 1024, "f32", channels_last=True)
    x = (x - 0.5) / 2 * 0.01 + 100
    want = group_norm_silu_reference(x.double(), w.double(), b.double(), 32, 1e-8, False)
    for held in (True, False):
        err = (_chunks(torch, x, w, b, 32, 1e-8, False, held).double() - want).abs().max().item()
        bad += not err <= 1e-2
        print(f"channels-last large mean, chunks held={held}: max err {err:.2e} "
              f"{'ok' if err <= 1e-2 else 'BAD'}", flush=True)
    return bad


def check(only_cl: bool = False) -> int:
    import torch
    from dmtpu_torch.ops import _build
    from dmtpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_reference, plan
    t0 = time.time()
    lib = _build.build()
    _build.library()
    print(_card(), f"; built and loaded in {time.time() - t0:.1f} s", flush=True)
    log = (lib.parent / "build.log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" in line and ("group_norm_held_kernel" in line or
                                          "group_norm_stream_kernel" in line or
                                          "group_norm_chunks_kernel" in line):
            print("  ", " | ".join(x.strip()[:110] for x in log[i:i + 4]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if only_cl:
        bad = check_channels_last(torch, gen)
        print("check:", "FAILED" if bad else "all ok")
        return 1 if bad else 0
    bad = 0
    for n, c, hw, dname, silu, groups in CHECK_SHAPES:
        x, w, b = _inputs(torch, gen, n, c, hw, dname)
        want = group_norm_silu_reference(x, w, b, groups, 1e-6, silu)
        how = plan(c, hw, groups, x.element_size(), False, n)
        line = f"b{n} C={c} HW={hw} G={groups} {dname} silu={silu} plan {how}:"
        for kernel in ("team", "nchw"):
            y = group_norm_silu(x, w, b, groups, 1e-6, silu, kernel=kernel)
            again = group_norm_silu(x, w, b, groups, 1e-6, silu, kernel=kernel)
            torch.cuda.synchronize()
            ok, err = _close(torch, y, want)
            same = torch.equal(y, again)
            bad += not (ok and same)
            line += f" {kernel} max err {err:.2e} same bits {same} {'ok' if ok and same else 'BAD'};"
        print(line, flush=True)
        del x, y, again, want
        torch.cuda.empty_cache()
    for (n, c, hw, dname), (form, team, ctas) in FORCED:
        x, w, b = _inputs(torch, gen, n, c, hw, dname)
        want = group_norm_silu_reference(x, w, b, 32, 1e-6, True)
        y = _forced(torch, x, w, b, 32, 1e-6, True, form, team, ctas)
        again = _forced(torch, x, w, b, 32, 1e-6, True, form, team, ctas)
        torch.cuda.synchronize()
        ok, err = _close(torch, y, want)
        same = torch.equal(y, again)
        bad += not (ok and same)
        print(f"forced {form} team {team} CTAs {ctas} b{n} C={c} HW={hw} {dname}: max err {err:.2e} "
              f"same bits {same} {'ok' if ok and same else 'BAD'}", flush=True)
    # mean >> std: the shifted sums keep the variance (bound as in the card tests)
    x, w, b = _inputs(torch, gen, 2, 320, 1024, "f32")
    x = (x - 0.5) / 2 * 0.01 + 100
    want = group_norm_silu_reference(x.double(), w.double(), b.double(), 32, 1e-8, False)
    got = group_norm_silu(x, w, b, 32, 1e-8, False, kernel="team")
    err = (got.double() - want).abs().max().item()
    bad += not err <= 1e-2
    print(f"large mean: max err {err:.2e} {'ok' if err <= 1e-2 else 'BAD'}")
    bad += check_channels_last(torch, gen)
    print("check:", "FAILED" if bad else "all ok")
    return 1 if bad else 0


def timing(only_cl: bool = False) -> int:
    import torch
    import torch.nn.functional as F
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.groupnorm import group_norm_silu, plan
    print(_card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, (n, eps, table) in ({} if only_cl else PATHS).items():
        sums = dict(team=0.0, nchw=0.0, library=0.0, clone=0.0, bound=0.0)
        for (c, hw, dname, silu), calls in sorted(table.items()):
            x, w, b = _inputs(torch, gen, n, c, hw, dname)
            wl, bl = w.to(x.dtype), b.to(x.dtype)

            def library():
                y = F.group_norm(x, 32, wl, bl, eps)
                return F.silu(y) if silu else y

            row = {name: _device_ms(torch, lambda name=name: group_norm_silu(
                x, w, b, 32, eps, silu, kernel=name), 10) for name in ("team", "nchw")}
            row["library"] = _device_ms(torch, library, 10)
            row["clone"] = _device_ms(torch, x.clone, 10)
            row["bound"] = roofline.bound_ms(*roofline.group_norm_work(n, c, hw, x.element_size(),
                                                                     silu),
                                             peak_flops=roofline.PEAK_F32_FLOPS)[0]
            for key in sums:
                sums[key] += calls * row[key]
            how = plan(c, hw, 32, x.element_size(), False, n)
            print(f"{label} b{n} C={c} HW={hw} {dname} silu={silu} x{calls} plan "
                  f"{how['kernel']} {how['form']} team {how['team']} ctas {how['ctas']}: device ms "
                  + " ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
            del x
            torch.cuda.empty_cache()
        print(f"SUM {label} (one call's GroupNorms), device ms: "
              + " ".join(f"{k} {v:.3f}" for k, v in sums.items()), flush=True)
    timing_channels_last(torch, F, gen)
    return 0


def timing_channels_last(torch, F, gen) -> None:
    """At each shape of ``CL_PATHS``: the device time of "groups", of
    "chunks" as planned and in its other form, of the library call, of
    ``x.clone()`` and the bound; each path's sums over one call."""
    from dmtpu_torch.ops import roofline
    from dmtpu_torch.ops.groupnorm import group_norm_silu, plan
    for label, (n, eps, table) in CL_PATHS.items():
        sums = {}
        for (c, hw, dname, silu), calls in sorted(table.items()):
            x, w, b = _inputs(torch, gen, n, c, hw, dname, channels_last=True)
            wl, bl = w.to(x.dtype), b.to(x.dtype)

            def library():
                y = F.group_norm(x, 32, wl, bl, eps)
                return F.silu(y) if silu else y

            how = plan(c, hw, 32, x.element_size(), True, n)
            row = {name: _device_ms(torch, lambda name=name: group_norm_silu(
                x, w, b, 32, eps, silu, kernel=name), 10) for name in ("groups", "chunks")}
            other = _other_form(c, hw, 32, x.element_size(), n)
            if other is not None:
                row["chunks_" + ("held" if other else "streamed")] = _device_ms(
                    torch, lambda: _chunks(torch, x, w, b, 32, eps, silu, other), 10)
            row["library"] = _device_ms(torch, library, 10)
            row["clone"] = _device_ms(torch, x.clone, 10)
            row["bound"] = roofline.bound_ms(*roofline.group_norm_work(n, c, hw, x.element_size(),
                                                                     silu),
                                             peak_flops=roofline.PEAK_F32_FLOPS)[0]
            for key, value in row.items():
                sums[key] = sums.get(key, 0.0) + calls * value
            print(f"{label} b{n} C={c} HW={hw} {dname} silu={silu} x{calls} channels-last plan "
                  f"{how}: device ms " + " ".join(f"{k} {v:.4f}" for k, v in row.items()),
                  flush=True)
            del x
            torch.cuda.empty_cache()
        print(f"SUM {label} (one call's small-group channels-last GroupNorms), device ms: "
              + " ".join(f"{k} {v:.4f}" for k, v in sums.items()), flush=True)


def variants(only_cl: bool = False) -> int:
    import torch
    from dmtpu_torch.ops.groupnorm import team_plan
    print(_card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, c, hw, dname in [] if only_cl else VARIANT_SHAPES:
        x, w, b = _inputs(torch, gen, n, c, hw, dname)
        planned = team_plan(c, hw, 32, x.element_size(), n, sms)
        form, team = planned["form"], planned["team"]
        shapes = {(form, team, planned["ctas"])}
        if form == "stream":  # teams of every size that divides the SMs, and powers of two
            for t in sorted({t for t in range(1, sms + 1) if sms % t == 0}
                            | {2 ** i for i in range(8) if 2 ** i <= sms}):
                shapes.add(("stream", t, t * max(1, min(n * 32, sms // t))))
        else:
            shapes.add(("stream", 1, min(n * 32, sms)))
        row = {}
        for f, t, ctas in sorted(shapes):
            row[f"{f} team {t} ctas {ctas}"] = round(_device_ms(
                torch, lambda: _forced(torch, x, w, b, 32, 1e-6, True, f, t, ctas), 10), 4)
        print(f"b{n} C={c} HW={hw} {dname} plan {planned}: device ms {row}; x.clone() "
              f"{_device_ms(torch, x.clone, 10):.4f}", flush=True)
        del x
        torch.cuda.empty_cache()
    # the chunks kernel at every cluster size and CTA size (periods a pass),
    # held and streamed, at each shape of the channels-last paths
    from dmtpu_torch.ops.groupnorm import SMEM_LIMIT, chunks_plan
    shapes = sorted({(n, c, hw, dname) for n, _, table in CL_PATHS.values()
                     for c, hw, dname, _ in table})
    for n, c, hw, dname in shapes:
        x, w, b = _inputs(torch, gen, n, c, hw, dname, channels_last=True)
        planned = chunks_plan(c, hw, 32, x.element_size(), n)
        row = {}
        for held in (True, False):
            for cluster in (1, 2, 4, 8):
                for periods in (4, 8, 16, 32):
                    how = chunks_plan(c, hw, 32, x.element_size(), n, held, cluster, periods)
                    if how["smem"] > SMEM_LIMIT or how["threads"] > 512 or \
                            (held and (hw * c) % 8):
                        continue
                    row[f"{'held' if held else 'streamed'} cluster {cluster} threads "
                        f"{how['threads']}"] = round(_device_ms(torch, lambda: _chunks(
                            torch, x, w, b, 32, 1e-5, True, held, cluster, periods), 10), 4)
        print(f"chunks b{n} C={c} HW={hw} {dname} channels-last plan {planned}: device ms {row}; "
              f"x.clone() {_device_ms(torch, x.clone, 10):.4f}", flush=True)
        del x
        torch.cuda.empty_cache()
    # where "rows" takes the call (the SD1.5 UNet's shapes): rows against chunks
    from dmtpu_torch.ops.groupnorm import group_norm_silu
    for n, c, hw in ROWS_SHAPES:
        x, w, b = _inputs(torch, gen, n, c, hw, "bf16", channels_last=True)
        row = {name: round(_device_ms(torch, lambda name=name: group_norm_silu(
            x, w, b, 32, 1e-5, True, kernel=name), 10), 4) for name in ("rows", "chunks")}
        print(f"rows shape b{n} C={c} HW={hw} bf16 channels-last: device ms {row}; chunks plan "
              f"{chunks_plan(c, hw, 32, 2, n)}", flush=True)
    return 0


PHASES = {"check": check, "time": timing, "variants": variants}


def main(argv: list[str]) -> int:
    if argv:
        return PHASES[argv[0]](argv[1:] == ["cl"])
    for phase, limit in PHASE_LIMITS.items():
        try:
            rc = subprocess.run([sys.executable, "-m", "dmtpu_torch.dev.k3_probe", phase],
                                cwd=ROOT, timeout=limit).returncode
        except subprocess.TimeoutExpired:
            print(f"{phase}: no end within {limit} s (a team that waits for ever?)")
            return 5
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
