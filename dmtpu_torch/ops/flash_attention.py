"""K1 and K2: hand-written attention forward and backward for Hopper.

Counterpart of ``dmtpu/ops/flash_small_d.py`` (its ``_fwd`` and ``_bwd``
paths and the ``custom_vjp`` that joins them).  Layout is [B, S, H, D] as
in ``dmtpu.ops.attention``; unlike the TPU kernels these take S_q != S_k
(cross-attention), head dims that are multiples of 8 up to 512 (zero-padded
to 48, 80, 160, 256 or 512 in shared memory) and ragged sequence lengths
(masked).

- ``flash_attention(q, k, v, scale) -> o``: the differentiable op
  (``FlashAttention``, a ``torch.autograd.Function``): its forward runs
  ``flash_attention_fwd`` and saves q, k, v, o and the lse; its backward runs
  ``flash_attention_bwd``.
- ``flash_attention_fwd(q, k, v, scale) -> (o, lse)`` (K1): ``lse`` is the
  f32 row logsumexp [B, H, S_q] that the backward consumes.  Two kernels
  stand behind it: ``csrc/flash_attn_fwd.cu`` (wgmma and TMA, head dims 40,
  64, 72 and 80, the long self-attention shapes) and the mma.sync kernel
  (everything else): ``csrc/flash_attn_fwd_mma.cu`` up to 256 and
  ``csrc/flash_attn_fwd_mma_d512.cu`` above; ``select_kernel`` is the gate.
- ``flash_attention_bwd(q, k, v, o, lse, do, scale) -> (dq, dk, dv)`` (K2).
  Two kernels stand behind it as well: ``csrc/flash_attn_bwd.cu`` (wgmma and
  TMA, head dims 40, 64, 72 and 80; dQ's partial sums leave a CTA as whole f32
  tiles by ``cp.reduce.async.bulk``) and ``csrc/flash_attn_bwd_mma.cu``
  (mma.sync, dQ by scalar f32 atomics; everything else: up to 256 there,
  above it ``csrc/flash_attn_bwd_mma_d512.cu``, dK, dV and dQ split by
  column halves over two CTAs); ``select_bwd_kernel`` is the gate.  Where
  several key tiles add to dq, neither gives a bitwise reproducible dq: the
  f32 adds of different CTAs arrive in an order that varies from run to run.  With one key tile
  (S_k <= 128) the wgmma kernel writes dq itself, in bf16, and two runs
  agree bit for bit.
- ``flash_attention_reference`` and ``flash_attention_backward_reference``:
  the plain PyTorch versions of the same math in f32 (P cast to V's dtype
  for PV and dV, dS cast to Q's dtype for dK and dQ, as the TPU kernels
  cast them).

Each wrapper launches its kernel on a CUDA tensor (bf16 only; anything else
raises) and runs its plain version on a CPU tensor, so on the CPU the
``FlashAttention`` function is the plain forward and backward.  Each
wrapper's ``launches`` counts kernel launches, and its ``launches_by_kernel``
counts them by the kernel that ran and its ``launches_by_head_dim`` by head
dim; ``kernel=`` forces one.
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


# The widest head dim the kernels take: K1's and K2's mma.sync kernels have an
# instance at 512 (CelebA-HQ's UNet, configs/ddpm_celebahq.yaml: one head as
# wide as its 512 channels).
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
# and 128 keys a tile) is instantiated for head dims 40 and 80 (SD1.5), 72
# (DiT) and 64 (MMDiT) and needs a positive scale (it takes the running max
# before scaling); "mma" (mma.sync) takes every head dim up to 512: up to 256
# csrc/flash_attn_fwd_mma.cu (64 x 64 tiles; the CIFAR UNets' d=256 runs
# there), above it csrc/flash_attn_fwd_mma_d512.cu (64 rows x 32 keys, O's
# columns split over two CTAs; CelebA-HQ's d=512).
WGMMA_HEAD_DIMS = (40, 64, 72, 80)
# Below this many keys the wgmma kernel is one 128-key tile, mostly masked,
# and the mma.sync kernel is as fast or faster; see the gate's numbers in
# ``select_kernel``.
WGMMA_MIN_KEYS = 129


def kernels_for(d: int, scale: Optional[float] = None) -> list[str]:
    """The K1 kernels that take head dim ``d`` (and ``scale``), the general one first."""
    names = ["mma"]
    if d in WGMMA_HEAD_DIMS and (scale is None or scale > 0):
        names.append("wgmma")
    return names


def select_kernel(sq: int, sk: int, d: int, scale: Optional[float] = None) -> str:
    """The K1 kernel a call is dispatched to.

    Measured on an NVIDIA H100 80GB HBM3 (700 W) by ``chip_smoke.py`` phase 2,
    b16 h8 bf16, both kernels in one call, ms (mma.sync / wgmma): S=4096 d=40
    2.44-2.48 / 1.18; S=1024 d=80 0.257 / 0.118; S_q=4096 S_k=77 d=40 0.110 /
    0.123; S_q=1024 S_k=77 d=80 0.051 / 0.048, both within the 0.047 ms the
    host takes to launch one.  So the wgmma kernel takes what has more than
    one 128-key tile; with 77 keys its one tile is 40% masked keys and the
    shape stays on mma.sync.  DiT-XL/2's self-attention (phase 11, b64 h16
    S=256 d=72, two key tiles, q/k/v strided views of one projection), two
    timings each: mma.sync 0.1465 and 0.1463 ms, wgmma 0.1055 and 0.1052; so
    d=72 takes the same rule.  MMDiT's joint attention at d=64 (phase 13, q,
    k and v concatenated from the two streams, a masked last key tile): b4
    h24 S=4250, mma.sync 2.967 and 2.951 ms, wgmma 1.058 and 1.061; b64 h12
    S=333 (77 of its third key tile's 128 keys valid), mma.sync 0.2178 and
    0.2139, wgmma 0.1220 and 0.1214; so d=64 takes it too.
    """
    if "wgmma" in kernels_for(d, scale) and sk >= WGMMA_MIN_KEYS:
        return "wgmma"
    return "mma"


_ENTRY_POINTS = {"mma": "dmtpu_flash_attn_fwd_mma", "wgmma": "dmtpu_flash_attn_fwd"}
# the mma.sync kernel's instance for head dims above this one lives in its own
# source, behind its own entry point
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
        kernel = select_kernel(sq, sk, d, scale)
        if kernel == "wgmma" and min(strides) <= 0:  # a broadcast view: no tensor map
            kernel = "mma"
    elif kernel not in kernels_for(d, scale) or (kernel == "wgmma" and min(strides) <= 0):
        raise ValueError(f"flash_attention: kernel {kernel!r} does not take head dim {d}, "
                         f"scale {scale}, strides {strides}")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    entry = _WIDE_ENTRY_POINT if d > MMA_NARROW_HEAD_DIM else _ENTRY_POINTS[kernel]
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
# (csrc/flash_attn_bwd.cu: a CTA per 128-key tile, TMA loads, a ring of Q / dO
# stages, wgmma for the five products, dQ added into an f32 buffer by whole
# tiles with cp.reduce.async.bulk) is instantiated for head dims 40 and 80
# (SD1.5), 72 (DiT) and 64 (MMDiT) and reads q, k, v and dO through tensor maps (positive
# strides); "mma" (mma.sync, dQ by scalar f32 atomics) takes every head dim
# up to 512 and any strides: up to 256 csrc/flash_attn_bwd_mma.cu (64-key
# tiles; the pixel UNets' d=256 runs there), above it
# csrc/flash_attn_bwd_mma_d512.cu (32-key tiles, dK, dV and dQ's columns split
# over two CTAs; CelebA-HQ's d=512).
_BWD_ENTRY_POINTS = {"mma": "dmtpu_flash_attn_bwd_mma", "wgmma": "dmtpu_flash_attn_bwd"}
_BWD_WIDE_ENTRY_POINT = "dmtpu_flash_attn_bwd_mma_d512"
WGMMA_BWD_HEAD_DIMS = (40, 64, 72, 80)
# the wgmma kernel pads its f32 scratch to whole steps of rows
_BWD_ROWS = {40: 128, 64: 64, 72: 64, 80: 64}
# Its key tile.  With no more keys than this a CTA holds every contribution to
# its dq rows: it writes them in bf16 itself, the same bits in every run, and
# needs no f32 sums.
WGMMA_BWD_KEY_TILE = 128


def bwd_kernels_for(d: int) -> list[str]:
    """The K2 kernels that take head dim ``d``, the general one first."""
    return ["mma", "wgmma"] if d in WGMMA_BWD_HEAD_DIMS else ["mma"]


def select_bwd_kernel(sq: int, sk: int, d: int, scale: Optional[float] = None) -> str:
    """The K2 kernel a call is dispatched to: "wgmma" wherever it is
    instantiated (head dims 40, 64, 72 and 80), whatever the lengths.  ``scale``
    does not matter to K2, which reads the saved lse; the argument mirrors
    ``select_kernel``.

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
    """
    return "wgmma" if "wgmma" in bwd_kernels_for(d) else "mma"


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
    raises if that kernel does not take the call: a head dim other than 40,
    72 or 80, or a q, k, v or ``do`` broadcast over batch, rows or heads, whose zero
    stride has no tensor map); by default ``select_bwd_kernel`` chooses and
    leaves such a call to "mma".
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
        kernel = select_bwd_kernel(sq, sk, d, scale)
        if kernel == "wgmma" and min(mapped) <= 0:  # a broadcast view: no tensor map
            kernel = "mma"
    elif kernel not in bwd_kernels_for(d) or (kernel == "wgmma" and min(mapped) <= 0):
        raise ValueError(f"flash_attention_bwd: kernel {kernel!r} does not take head dim {d}, "
                         f"strides {mapped}")
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    # one f32 scratch for both kernels' per-row statistics and f32 dQ sums
    if kernel == "wgmma":
        rows = b * h * _round_up(sq, _BWD_ROWS[d])
        n_stat = 2 * rows  # lse * log2(e) and delta
        n_sums = 0 if sk <= WGMMA_BWD_KEY_TILE else rows * d  # one key tile writes dq itself
    else:
        rows = b * h * sq
        n_stat = _round_up(rows, 4)  # delta; the sums that follow stay 16-byte aligned
        n_sums = rows * d
    scratch = torch.empty(n_stat + n_sums, dtype=torch.float32, device=dev)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=dev)
    entry = _BWD_WIDE_ENTRY_POINT if d > MMA_NARROW_HEAD_DIM else _BWD_ENTRY_POINTS[kernel]
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


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is K1 and whose backward is K2 (their plain
    versions on the CPU); the port of ``flash_small_d``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: Optional[float]) -> torch.Tensor:
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable attention through K1 and K2, [B, S, H, D] -> [B, S_q, H, D]."""
    return FlashAttention.apply(q, k, v, scale)
