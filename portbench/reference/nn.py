"""Plain building blocks of the reference models, in float32.

Every matrix product of the reference goes through ``Linear``, ``Conv2d`` or
``Attend`` below, so that one switch, ``set_precision``, can compute them in
a lower precision for the control of the correctness check:

- ``None``: float32 operands and float32 products (the reference itself;
  ``portbench.reference.no_tf32`` keeps TF32 off on the card);
- ``"bf16"``: operands rounded to bfloat16, products in bfloat16;
- ``"fp8"``: operands rounded to float8 e4m3 with one scale a tensor (its
  absolute maximum onto 448), then multiplied in bfloat16, which is exact
  for such operands.

Normalisations, softmax statistics, the residual stream and everything else
stay float32 in every mode.  Nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0
QUERY_BLOCK = 1024  # queries a block: keeps the f32 logits of long sequences small


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale, in bfloat16; the
    gradient passes the rounding unchanged (as fp8 training takes it)."""
    t = t.float()
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return (t + (q - t).detach()).to(torch.bfloat16)


def operands(precision: Optional[str], *tensors: Optional[torch.Tensor]):
    """``tensors`` as a product in ``precision`` takes them."""
    if precision is None:
        return tuple(None if t is None else t.float() for t in tensors)
    if precision == "bf16":
        return tuple(None if t is None else t.to(torch.bfloat16) for t in tensors)
    if precision == "fp8":
        # a bias is added after the product, as the accumulator's dtype has it
        return tuple(None if t is None else (_fp8(t) if t.dim() > 1 else t.to(torch.bfloat16))
                     for t in tensors)
    raise ValueError(f"unknown precision {precision!r}")


class Linear(nn.Linear):
    precision: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*operands(self.precision, x, self.weight, self.bias)).float()


class Conv2d(nn.Conv2d):
    precision: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*operands(self.precision, x, self.weight, self.bias)).float()


class Attend(nn.Module):
    """softmax(q k^T * scale) v over [B, S, H, D] tensors, the softmax in
    float32.  No parameters; a module so that the FLOP counter and the
    table of kernel calls can see each call's shapes."""

    precision: Optional[str] = None

    def __init__(self, causal: bool = False):
        super().__init__()
        self.causal = causal

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: Optional[float] = None) -> torch.Tensor:
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        q, k, v = operands(self.precision, q, k, v)
        outs = []
        for start in range(0, q.shape[1], QUERY_BLOCK):
            qb = q[:, start:start + QUERY_BLOCK]
            logits = torch.einsum("bqhd,bkhd->bhqk", qb, k).float() * scale
            if self.causal:
                sq, sk = logits.shape[-2:]
                rows = torch.arange(start, start + sq, device=q.device)[:, None]
                mask = torch.arange(sk, device=q.device)[None] > rows
                logits = logits.masked_fill(mask, float("-inf"))
            w = torch.softmax(logits, dim=-1).to(v.dtype)
            outs.append(torch.einsum("bhqk,bkhd->bqhd", w, v).float())
        return torch.cat(outs, dim=1)


class GroupNorm(nn.GroupNorm):
    """GroupNorm in float32, followed by a SiLU where ``silu`` is set."""

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        h = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return F.silu(h) if silu else h


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """The ADM / DiT sinusoidal embedding, cosines first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float64) / half)
    args = t.float()[:, None] * freqs.float().to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def set_precision(module: nn.Module, precision: Optional[str]) -> nn.Module:
    """Compute every product of ``module`` in ``precision`` (see the module
    docstring)."""
    operands(precision)  # validates the name
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d, Attend)):
            m.precision = precision
    return module


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """float32 products in float32 on the card: TF32 off for matmuls and
    convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
