"""K1 and K2: hand-written attention forward and backward for Hopper.

Counterpart of ``dmtpu/ops/flash_small_d.py`` (its ``_fwd`` and ``_bwd``
paths and the ``custom_vjp`` that joins them).  Layout is [B, S, H, D] as
in ``dmtpu.ops.attention``; unlike the TPU kernels these take S_q != S_k
(cross-attention), head dims that are multiples of 8 up to 512 (zero-padded
to 48, 80, 160, 256 or 512 in shared memory) and ragged sequence lengths
(masked).

- ``flash_attention_fwd(q, k, v, scale) -> (o, lse)`` (K1): ``lse`` is the
  f32 row logsumexp [B, H, S_q] that the backward consumes.  Two kernels
  stand behind it: ``csrc/flash_attn_fwd.cu`` (wgmma and TMA, head dims up
  to 512 on instances of 40, 64, 72, 80, 160, 256 and 512: every call of the
  repository's paths) and the mma.sync kernel (a non-positive scale, a
  broadcast q, k or v): ``csrc/flash_attn_fwd_mma.cu`` up to 256 and
  ``csrc/flash_attn_fwd_mma_d512.cu`` above; ``select_kernel`` is the gate.
- ``flash_attention_bwd(q, k, v, o, lse, do, scale) -> (dq, dk, dv)`` (K2).
  Two kernels stand behind it as well: ``csrc/flash_attn_bwd.cu`` (wgmma and
  TMA, head dims 40, 64, 72 and 80 on instances of their own, every multiple
  of 8 in (80, 256] on the column-split instances of 160 and 256, and in
  (256, 512] on the instance of 512, a cluster of two CTAs on the column
  halves; dQ's partial sums leave a CTA as whole f32 rows by
  ``cp.reduce.async.bulk``) and the mma.sync kernel (dQ by scalar f32
  atomics: head dims below 40, 48 and 56, a broadcast q, k, v or dO, in
  ``csrc/flash_attn_bwd_mma.cu``; above 256 ``csrc/flash_attn_bwd_mma_d512.cu``,
  dK, dV and dQ split by column halves over two CTAs);
  ``select_bwd_kernel`` is the gate.  Where
  several key tiles add to dq, neither gives a bitwise reproducible dq: the
  f32 adds of different CTAs arrive in an order that varies from run to run.
  With one key tile the wgmma kernel writes dq itself, in bf16, and two runs
  agree bit for bit: S_k <= 128 at head dims up to 80, S_k <= 64 above
  (``wgmma_bwd_key_tile``; CelebA-HQ's S=64 at d=512 among them).  So SD1.5's d=160 cross-attention to 77 keys,
  two 64-key tiles, adds f32 partial sums and is not reproducible bit for
  bit, while its S=64 self-attention at d=160 is.
- ``flash_attention_reference`` and ``flash_attention_backward_reference``:
  the plain PyTorch versions of the same math in f32 (P cast to V's dtype
  for PV and dV, dS cast to Q's dtype for dK and dQ, as the TPU kernels
  cast them).

Each wrapper launches its kernel on a CUDA tensor (bf16 only; anything else
raises) and runs its plain version on a CPU tensor.  The differentiable
attention that joins them is the operator ``torch.ops.dmtpu.attention``
(``dmtpu_torch.ops.attention``).  Each wrapper's ``launches`` counts kernel
launches, and its ``launches_by_kernel`` counts them by the kernel that ran
and its ``launches_by_head_dim`` by head dim; ``kernel=`` forces one.
"""
from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from dmtpu_torch.ops import _build


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: Optional[float] = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: f32 logits ``q·k * scale``, f32 softmax,
    P cast to ``v.dtype`` for the PV product.  [B, S, H, D] in and out."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def flash_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                       scale: Optional[float] = None
                                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2, in f32: P from the saved lse, delta = rowsum(dO o O),
    dS = P (dP - delta) scale; P cast to ``v.dtype`` for dV and dS to
    ``q.dtype`` for dK and dQ.  Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.einsum("bqhd,bkhd->bhqk", qf, kf).mul_(scale).sub_(lse[..., None]).exp_()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dof)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # [B, H, S_q]
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf).sub_(delta[..., None]).mul_(p).mul_(scale)
    del p
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _passable(t: torch.Tensor) -> bool:
    """[B, S, H, D] with contiguous D and 16-byte aligned rows (strides % 8 == 0)."""
    if t.dim() != 4:
        return False
    sb, ss, sh, sd = t.stride()
    return sd == 1 and not (sb | ss | sh) & 7 and not t.data_ptr() & 15


def _check_bshd(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bfloat16 on CUDA, got {t.dtype}")
    if not _passable(t):
        raise ValueError(f"flash_attention: {name} must be [B, S, H, D] with contiguous D and "
                         f"16-byte aligned rows (strides % 8 == 0), got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")


# The widest head dim the kernels take: K1's wgmma and mma.sync kernels and
# K2's mma.sync kernel have an instance at 512 (CelebA-HQ's UNet,
# configs/ddpm_celebahq.yaml: one head as wide as its 512 channels).
MAX_HEAD_DIM = 512


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, backward: bool = False) -> None:
    """Raises on what the kernels do not take (naming K2 when ``backward``).
    It runs before every launch, so it compares plain ints and builds its
    message only on failure."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    d = q.shape[3]
    if d & 7 or d > MAX_HEAD_DIM:
        name = "flash_attention_bwd: K2" if backward else "flash_attention: K1"
        raise ValueError(f"{name} takes head dims that are multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    device = q.get_device()
    if k.get_device() != device or v.get_device() != device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    _check_bshd("q", q)
    _check_bshd("k", k)
    _check_bshd("v", v)


# K1 is two hand-written kernels with one interface.  "wgmma"
# (csrc/flash_attn_fwd.cu: TMA loads, a ring of K/V stages, wgmma, 128 Q rows
# a CTA) is instantiated for head dims 40 and 80 (SD1.5), 72 (DiT), 64
# (MMDiT, SDXL, ADM), 160 (SD1.5), 256 (the CIFAR UNets) and 512 (CelebA-HQ:
# 64 Q rows a CTA, O's columns split over its two consumer warpgroups); a
# head dim between two instances runs on the wider one, its columns past the
# head dim zero-filled.  It needs a positive scale (it takes the running max
# before scaling) and tensor maps (no zero strides).  "mma" (mma.sync) takes
# every head dim up to 512 and any strides and scale: up to 256
# csrc/flash_attn_fwd_mma.cu (64 x 64 tiles), above it
# csrc/flash_attn_fwd_mma_d512.cu (64 rows x 32 keys, O's columns split over
# two CTAs).
WGMMA_HEAD_DIMS = (40, 64, 72, 80, 160, 256, 512)


def wgmma_instance(d: int) -> Optional[int]:
    """The wgmma kernel's instance that runs head dim ``d``: the narrowest at
    least as wide, or None above the widest."""
    return next((width for width in WGMMA_HEAD_DIMS if width >= d), None)


def kernels_for(d: int, scale: Optional[float] = None) -> list[str]:
    """The K1 kernels that take head dim ``d`` (and ``scale``), the general one first."""
    names = ["mma"]
    if wgmma_instance(d) is not None and (scale is None or scale > 0):
        names.append("wgmma")
    return names


def select_kernel(d: int, scale: Optional[float] = None) -> str:
    """The K1 kernel a call is dispatched to: "wgmma" wherever it takes the
    call (every head dim up to 512, a positive scale), whatever the lengths;
    ``flash_attention_fwd`` also leaves a broadcast (zero-stride) q, k or v to
    "mma".

    Measured on an NVIDIA H100 80GB HBM3 (700 W) by ``python -m
    dmtpu_torch.dev.k1_probe time``, device time of one call
    (``torch.profiler``), ms, mma.sync / wgmma, at every shape of the
    repository's paths whose head dim has a wgmma instance.  SD1.5 at b16 h8
    (b32 in brackets): S=4096 d=40 2.450 / 1.187 (4.814 / 2.321); S=1024
    d=80 0.2535 / 0.1095 (0.4841 / 0.2085); S=256 d=160 0.0395 / 0.0215
    (0.0707 / 0.0410); S=64 d=160 0.0070 / 0.0067 (0.0113 / 0.0102);
    S_q=4096 S_k=77 d=40 0.1073 / 0.0857 (0.2084 / 0.1743); S_q=1024 S_k=77
    d=80 0.0473 / 0.0301 (0.0876 / 0.0563); S_q=256 S_k=77 d=160 0.0234 /
    0.0121 (0.0452 / 0.0257); S_q=64 S_k=77 d=160 0.0086 / 0.0074 (0.0132 /
    0.0109).  SDXL's cross-attention at b2, h10 S_q=4096 and h20 S_q=1024,
    S_k=77 d=64: 0.0288 / 0.0140 and 0.0162 / 0.0099.  ADM-256's 8x8 level,
    b16 h8 S=64 d=64: 0.0043 / 0.0045.  The CIFAR UNet at b500 h1 d=256:
    S=256 0.2505 / 0.1195; S=16 0.0200 / 0.0158; S=200 0.2335 / 0.1110; at
    b20 (the AdaGN UNet's CFG batch) S=256 0.0180 / 0.0140, S=16 0.0054 /
    0.0053; at b128 (a train step) S=256 0.0689 / 0.0358, and a ring hop of
    S=64 0.0101 / 0.0096.  The wgmma kernel is the faster or level (ADM's
    S=64 row, 5%) at every shape; below 0.05 ms both are within the 0.05-0.06
    ms the host takes to launch one through this wrapper.  Until head dims
    160 and 256 had instances and the wgmma kernel its short-key tile and
    persistent CTAs, every call with at most 128 keys, and head dims 160 and
    256, stayed on mma.sync.

    Head dim 512 (``python -m dmtpu_torch.dev.k1_probe d512``, the same card,
    device time, mma.sync / wgmma, SDPA's memory-efficient backend in
    brackets): CelebA-HQ's b16 h1 S=256 0.0278 / 0.0244 (0.0232) and S=64
    0.0099 / 0.0098 (0.0109); a ragged b4 S=200 0.0225 / 0.0218 (0.0223);
    b4 S=256 d=504 0.0258 / 0.0255 (0.0265); b128 S=256, where the card sets
    the pace, 0.1974 / 0.1055 (0.1327).  The wgmma instance is the faster or
    level at each, so it takes head dims 264 to 512 too.
    """
    return "wgmma" if "wgmma" in kernels_for(d, scale) else "mma"


_ENTRY_POINTS = {"mma": "dmtpu_flash_attn_fwd_mma", "wgmma": "dmtpu_flash_attn_fwd"}
# the mma.sync kernels' instances for head dims above this one live in their
# own sources, behind their own entry points (K1's and K2's)
MMA_NARROW_HEAD_DIM = 256
_WIDE_ENTRY_POINT = "dmtpu_flash_attn_fwd_mma_d512"
_LOG2E = math.log2(math.e)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None, kernel: Optional[str] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention forward, [B, S, H, D] -> ([B, S_q, H, D], lse [B, H, S_q]).

    ``kernel`` forces "mma" or "wgmma" (it raises if that kernel does not take
    the call); by default ``select_kernel`` chooses.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    if kernel is None:
        kernel = select_kernel(d, scale)
        if kernel == "wgmma" and min(strides) <= 0:  # a broadcast view: no tensor map
            kernel = "mma"
    elif kernel not in kernels_for(d, scale) or (kernel == "wgmma" and min(strides) <= 0):
        raise ValueError(f"flash_attention: kernel {kernel!r} does not take head dim {d}, "
                         f"scale {scale}, strides {strides}")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    entry = (_WIDE_ENTRY_POINT if kernel == "mma" and d > MMA_NARROW_HEAD_DIM
             else _ENTRY_POINTS[kernel])
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, h, sq, sk, d, *strides, *out.stride()[:3], scale * _LOG2E,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention launch")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_by_kernel[kernel] += 1
    flash_attention_fwd.launches_by_head_dim[d] += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_kernel = {"mma": 0, "wgmma": 0}
flash_attention_fwd.launches_by_head_dim = collections.Counter()


# K2 is two hand-written kernels with one interface, as K1 is.  "wgmma"
# (csrc/flash_attn_bwd.cu: TMA loads, a ring of Q / dO stages, wgmma for the
# five products, dQ added into an f32 buffer by whole rows with
# cp.reduce.async.bulk) reads q, k, v and dO through tensor maps (positive
# strides).  Its instances: head dims 40 and 80 (SD1.5), 72 (DiT) and 64
# (MMDiT), a CTA per 128-key tile, two consumer warpgroups of 64 keys each;
# 160 (SD1.5) and 256 (the pixel UNets), a CTA per 64-key tile, both
# consumer warpgroups on all 64 keys and each on its share of dK's, dV's and
# dQ's columns; and 512 (CelebA-HQ), a cluster of two such CTAs per 64-key
# tile, each on half of the columns, their partial S^T and dP^T summed
# through distributed shared memory.  Every multiple of 8 in (80, 512] runs
# on the narrowest of 160, 256 and 512 that is at least as wide, its columns
# past the head dim zero-filled.  "mma" (mma.sync, dQ by scalar f32 atomics)
# takes every head dim up to 512 and any strides: up to 256
# csrc/flash_attn_bwd_mma.cu (64-key tiles; the head dims below 40, 48 and
# 56, and zero strides, run there), above it csrc/flash_attn_bwd_mma_d512.cu
# (32-key tiles, dK, dV and dQ's columns split over two CTAs).
_BWD_ENTRY_POINTS = {"mma": "dmtpu_flash_attn_bwd_mma", "wgmma": "dmtpu_flash_attn_bwd"}
_BWD_WIDE_ENTRY_POINT = "dmtpu_flash_attn_bwd_mma_d512"
WGMMA_BWD_HEAD_DIMS = (40, 64, 72, 80, 160, 256, 512)
# the instances whose two consumer warpgroups split the columns (64-key tiles)
WGMMA_BWD_SPLIT_HEAD_DIMS = (160, 256)
# the instance of a cluster of two CTAs on the column halves, each laid out as
# the split instance at 256 (64-key tiles)
WGMMA_BWD_PAIR_HEAD_DIMS = (512,)
# the wgmma kernel pads its f32 scratch to whole steps of rows, by instance
_BWD_ROWS = {40: 128, 64: 64, 72: 64, 80: 64, 160: 64, 256: 64, 512: 64}
# Its key tile up to head dim 80.  With no more keys than its instance's tile
# (wgmma_bwd_key_tile) a CTA holds every contribution to its dq rows: it
# writes them in bf16 itself, the same bits in every run, and needs no f32
# sums.
WGMMA_BWD_KEY_TILE = 128
WGMMA_BWD_SPLIT_KEY_TILE = 64


def wgmma_bwd_instance(d: int) -> Optional[int]:
    """K2's wgmma instance that runs head dim ``d``: 40, 64, 72 and 80 their
    own; a multiple of 8 in (80, 512] the narrowest of 160, 256 and 512 that
    is at least as wide; None for the rest (mma.sync)."""
    if d in (40, 64, 72, 80):
        return d
    if 80 < d <= 512 and not d & 7:
        return next(w for w in (160, 256, 512) if w >= d)
    return None


def wgmma_bwd_key_tile(d: int) -> int:
    """The keys of one CTA (of a CTA pair at 512) of K2's wgmma instance for
    head dim ``d``."""
    wide = wgmma_bwd_instance(d) in WGMMA_BWD_SPLIT_HEAD_DIMS + WGMMA_BWD_PAIR_HEAD_DIMS
    return WGMMA_BWD_SPLIT_KEY_TILE if wide else WGMMA_BWD_KEY_TILE


def bwd_kernels_for(d: int) -> list[str]:
    """The K2 kernels that take head dim ``d``, the general one first."""
    return ["mma", "wgmma"] if wgmma_bwd_instance(d) else ["mma"]


def select_bwd_kernel(d: int) -> str:
    """The K2 kernel a call is dispatched to: "wgmma" wherever it has an
    instance (head dims 40, 64, 72, 80 and every multiple of 8 in (80, 512]),
    whatever the lengths; ``flash_attention_bwd`` also leaves a broadcast
    (zero-stride) q, k, v or dO to "mma".

    Measured on an NVIDIA H100 80GB HBM3 (700 W) by ``chip_smoke.py`` phase 6,
    b16 h8 bf16, both kernels in one call, ms (mma.sync / wgmma): S=4096 d=40
    7.23-7.34 / 2.64-2.67; S=1024 d=80 1.08 / 0.40; S_q=4096 S_k=77 d=40
    0.55-0.57 / 0.152; S_q=1024 S_k=77 d=80 0.257 / 0.090, the last within the
    0.06-0.12 ms the host takes to launch one.  The wgmma kernel is the faster
    at every length, so unlike K1's gate this one has no key threshold.
    DiT-XL/2's attention backward (phase 12, b32 h16 S=256 d=72, two key
    tiles, q/k/v strided views of one projection), two timings each:
    mma.sync 0.3573 and 0.3567 ms, wgmma 0.1868 and 0.1867; d=72 takes the
    same rule.

    The column-split instances (``python -m dmtpu_torch.dev.k2_probe fresh``,
    the same card, device time, mma.sync / wgmma, cuDNN's backward in
    brackets): SD1.5 at b16 h8 d=160, S=256 0.2182 / 0.1146 (0.1122), S=64
    0.0402 / 0.0179 (0.0240), S_q=256 S_k=77 0.1328 / 0.0698 (0.0783), S_q=64
    S_k=77 0.0529 / 0.0280 (0.0252); the CIFAR UNet at b128 h1 d=256, S=256
    0.3523 / 0.1675 (0.1461), S=16 0.0440 / 0.0119 (0.0244); b8 S=200 d=256
    0.0848 / 0.0319 and S=256 d=248 0.0872 / 0.0330.  The wgmma kernel is
    the faster at every one, so it takes head dims 88 to 256 too.

    The CTA-pair instance of 512 (``python -m dmtpu_torch.dev.k2_probe
    d512``, the same card, device time, mma.sync / wgmma, SDPA's
    memory-efficient backward in brackets): CelebA-HQ's b16 h1 S=256 0.1960 /
    0.0372 (0.4077) and S=64 0.0758 / 0.0216 (0.1236); b4 S=200 0.1113 /
    0.0437; b4 S=256 d=504 0.1154 / 0.0456; b2 S_q=77 S_k=333 h2 0.0888 /
    0.0296; b2 S_q=333 S_k=40 d=264 0.1235 / 0.0502; b2 S_q=100 S_k=77 h2
    d=384 0.0743 / 0.0267; b128 S=256 1.2069 / 0.4290 (1.1058).  The wgmma
    instance is the faster at every one, so it takes head dims 264 to 512.
    """
    return "wgmma" if wgmma_bwd_instance(d) else "mma"


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, scale: Optional[float] = None,
                        kernel: Optional[str] = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward from K1's outputs: (dq, dk, dv), [B, S, H, D] each.

    q, k, v and o are read through their strides.  ``do`` is too, when its
    head dim is contiguous and its rows 16-byte aligned; a ``do`` that is not
    (autograd hands a gradient of all-zero strides for a ``sum()``) is copied
    with ``.contiguous()`` first.  ``kernel`` forces "mma" or "wgmma" (it
    raises if that kernel does not take the call: for "wgmma" a head dim
    without an instance (``wgmma_bwd_instance``: below 40, 48 and 56), or a
    q, k, v or ``do`` broadcast over batch, rows or heads, whose
    zero stride has no tensor map); by default ``select_bwd_kernel`` chooses
    and leaves a broadcast call to "mma".
    """
    if kernel is not None and kernel not in _BWD_ENTRY_POINTS:
        raise ValueError(f"flash_attention_bwd: unknown kernel {kernel!r}")
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_qkv(q, k, v, backward=True)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous f32 [{b}, {h}, {sq}], "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    device = q.get_device()
    if o.get_device() != device or lse.get_device() != device or do.get_device() != device:
        raise ValueError("flash_attention_bwd: all inputs must be on one device")
    if not _passable(do):
        do = do.contiguous()
    _check_bshd("o", o)
    _check_bshd("do", do)
    mapped = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    if kernel is None:
        kernel = select_bwd_kernel(d)
        if kernel == "wgmma" and min(mapped) <= 0:  # a broadcast view: no tensor map
            kernel = "mma"
    elif kernel not in bwd_kernels_for(d) or (kernel == "wgmma" and min(mapped) <= 0):
        raise ValueError(f"flash_attention_bwd: kernel {kernel!r} does not take head dim {d}, "
                         f"strides {mapped}")
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    # one f32 scratch for both kernels' per-row statistics and f32 dQ sums
    if kernel == "wgmma":
        width = wgmma_bwd_instance(d)  # the f32 sums' row width
        rows = b * h * _round_up(sq, _BWD_ROWS[width])
        n_stat = 2 * rows  # lse * log2(e) and delta
        # one key tile writes dq itself
        n_sums = 0 if sk <= wgmma_bwd_key_tile(d) else rows * width
    else:
        rows = b * h * sq
        n_stat = _round_up(rows, 4)  # delta; the sums that follow stay 16-byte aligned
        n_sums = rows * d
    scratch = torch.empty(n_stat + n_sums, dtype=torch.float32, device=dev)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=dev)
    entry = (_BWD_WIDE_ENTRY_POINT if kernel == "mma" and d > MMA_NARROW_HEAD_DIM
             else _BWD_ENTRY_POINTS[kernel])
    err = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * n_stat, dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, sq, sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], *do.stride()[:3], *dk.stride()[:3], *dv.stride()[:3], scale,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention_bwd launch")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_kernel[kernel] += 1
    flash_attention_bwd.launches_by_head_dim[d] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_kernel = {"mma": 0, "wgmma": 0}
flash_attention_bwd.launches_by_head_dim = collections.Counter()

