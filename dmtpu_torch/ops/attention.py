"""Attention ops: the plain PyTorch path and the single dispatch.

Counterpart of ``dmtpu/ops/attention.py``.  All shapes are **[B, S, H, D]**
(batch, sequence, heads, head_dim).

- ``mha``: plain attention, the exact math of ``dmtpu.ops.attention.mha``:
  q and k pre-scaled by ``sqrt(scale)``, logits in the input dtype when
  ``S_q * S_k <= 2**21`` and in f32 otherwise, f32 softmax, weights cast to
  v's dtype.
- ``attention``: the one dispatch every model calls.  Inside
  ``dispatch.plain_ops()`` it is ``mha`` under ordinary autograd, on any
  device.  Elsewhere, where autograd records it, it is the operator
  ``torch.ops.dmtpu.attention``; where it does not (no gradient mode, or no
  input that needs a gradient: sampling), it is the operator's forward
  called directly, K1 or ``mha``, without the operator's host cost.
- ``torch.ops.dmtpu.attention(q, k, v, scale) -> (o, lse)``: one
  ``torch.library.custom_op`` with its backward registered beside it.  On a
  CUDA tensor its forward is K1 (``flash_attention_fwd``) and its backward
  K2 (``flash_attention_bwd``), which raise on what they do not take; on a
  CPU tensor its forward is ``mha`` (``lse`` is empty) and its backward is
  ``mha``'s autograd, recomputed from the saved q, k and v, so the CPU
  numbers are those of plain autograd through ``mha``.  Being an operator,
  it is what the dispatcher sees of a kernel launch, so a selective
  checkpoint can save its outputs: the ``"attn"`` remat policy
  (``dmtpu_torch.ops.rematerialize``) keeps ``o`` and ``lse`` and the
  recompute does not launch K1 again.  The TPU dispatch gates of the JAX
  package are not carried over.
"""
from __future__ import annotations

from typing import Optional

import torch

from dmtpu_torch.ops.dispatch import kernels_enabled
from dmtpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention, [B, S, H, D] -> [B, S, H, D]; f32 softmax."""
    d = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    scale = (d ** -0.5) if scale is None else scale
    root = scale ** 0.5
    if sq * sk <= 2 ** 21:
        logits = torch.einsum("bqhd,bkhd->bhqk", q * root, k * root)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * root, k.float() * root)
    weights = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
    return out.to(q.dtype)


@torch.library.custom_op("dmtpu::attention", mutates_args=())
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: Optional[float]) -> tuple[torch.Tensor, torch.Tensor]:
    """(o [B, S_q, H, D], lse [B, H, S_q] f32; empty on the CPU)."""
    if q.device.type == "cpu":
        return mha(q, k, v, scale), q.new_empty(0, dtype=torch.float32)
    return flash_attention_fwd(q, k, v, scale)


@attention_op.register_fake
def _(q, k, v, scale):
    b, sq, h, _ = q.shape
    lse_shape = (0,) if q.device.type == "cpu" else (b, h, sq)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.scale = scale


def _backward(ctx, do: torch.Tensor, _dlse: Optional[torch.Tensor]):
    q, k, v, o, lse = ctx.saved_tensors
    if q.device.type != "cpu":
        return (*flash_attention_bwd(q, k, v, o, lse, do, ctx.scale), None)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = mha(*leaves, ctx.scale)
        return (*torch.autograd.grad(out, leaves, do), None)


attention_op.register_autograd(_backward, setup_context=_setup_context)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """[B, S, H, D] attention: ``torch.ops.dmtpu.attention`` (``mha`` on the
    CPU, K1 forward and K2 backward on CUDA) where autograd records it, its
    forward alone where it does not, or ``mha`` inside ``plain_ops()``."""
    if not kernels_enabled():
        return mha(q, k, v, scale)
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)):
        if q.device.type == "cpu":
            return mha(q, k, v, scale)
        return flash_attention_fwd(q, k, v, scale)[0]
    return attention_op(q, k, v, scale)[0]
