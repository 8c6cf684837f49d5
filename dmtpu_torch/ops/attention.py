"""Attention ops: the plain PyTorch path and the single dispatch.

Counterpart of ``dmtpu/ops/attention.py``.  All shapes are **[B, S, H, D]**
(batch, sequence, heads, head_dim).

- ``mha``: plain attention, the exact math of ``dmtpu.ops.attention.mha``:
  q and k pre-scaled by ``sqrt(scale)``, logits in the input dtype when
  ``S_q * S_k <= 2**21`` and in f32 otherwise, f32 softmax, weights cast to
  v's dtype.
- ``attention``: the one dispatch every model calls.  A CPU tensor, or any
  tensor inside ``dispatch.plain_ops()``, goes to ``mha``, whose gradient is
  ordinary autograd; a CUDA tensor goes to ``flash_attention``
  (``dmtpu_torch.ops.flash_attention``), the differentiable op whose
  forward is the K1 kernel and whose backward is the K2 kernel, which raise
  on what they do not take.  The TPU dispatch gates of the JAX package are
  not carried over.
"""
from __future__ import annotations

from typing import Optional

import torch

from dmtpu_torch.ops.dispatch import kernels_enabled
from dmtpu_torch.ops.flash_attention import flash_attention


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None) -> torch.Tensor:
    """[B, S, H, D] attention: ``mha`` on the CPU, K1 (forward) and K2
    (backward) on CUDA."""
    if q.device.type == "cpu" or not kernels_enabled():
        return mha(q, k, v, scale)
    return flash_attention(q, k, v, scale)
