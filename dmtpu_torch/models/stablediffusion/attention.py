"""SD cross-attention transformer blocks, in NCHW.

Counterpart of ``dmtpu/models/stablediffusion/attention.py`` (reference:
models/stablediffusion/attention.py — GEGLU :46-53, FeedForward :56-72,
CrossAttention :89-141, BasicTransformerBlock :199-228, SpatialTransformer
:231-285).  Every attention goes through ``dmtpu_torch.ops.attention`` in
the [B, S, H, D] layout; the SpatialTransformer's GroupNorm (eps 1e-6, no
SiLU) goes through ``group_norm``.  Token Merging (``tome_ratio`` > 0,
``dmtpu_torch.ops.tome``) wraps a block's self-attention.  SDXL's
SpatialTransformer (``use_linear=True``) projects the flattened tokens with
``nn.Linear`` layers in place of 1x1 convolutions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.models.adm import Conv2d, GroupNorm32, Linear
from dmtpu_torch.ops.attention import attention
from dmtpu_torch.ops.tome import bipartite_soft_matching_2d, tome_r


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype=None, device=None):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """``glu=True`` (the SD blocks' ``gated_ff``): GEGLU, then a Linear;
    ``glu=False``: a Linear, exact GELU, then a Linear (upstream keys
    ``net.0.0.*`` / ``net.2.*``; the JAX module's ``net__0__0`` /
    ``net__2``)."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = True, dtype=None, device=None):
        super().__init__()
        inner = int(dim * mult)
        project_in = (GEGLU(dim, inner, dtype=dtype, device=device) if glu else
                      nn.Sequential(Linear(dim, inner, dtype=dtype, device=device), nn.GELU()))
        self.net = nn.Sequential(project_in, nn.Dropout(0.0),
                                 Linear(inner, dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class CrossAttention(nn.Module):
    """Self- or cross-attention; q/k/v have no bias."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, dtype=None, device=None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_k = Linear(context_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_v = Linear(context_dim, inner, bias=False, dtype=dtype, device=device)
        self.to_out = nn.Sequential(Linear(inner, query_dim, dtype=dtype, device=device),
                                    nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        b, tq, _ = q.shape
        tk = k.shape[1]
        h, d = self.heads, self.dim_head
        out = attention(q.view(b, tq, h, d), k.view(b, tk, h, d), v.view(b, tk, h, d))
        return self.to_out(out.reshape(b, tq, h * d))


class BasicTransformerBlock(nn.Module):
    """(reference: models/stablediffusion/attention.py:199-228)

    ``tome_ratio > 0`` (serving; adds no parameters) merges tokens around the
    self-attention: the block input picks the matching (tomesd's call
    structure), ``attn1`` runs on N - r tokens, and its output is unmerged
    before the residual add.  Skipped when ``attn1`` is a cross-attention
    (``disable_self_attn``) or the token grid ``hw`` is not given.
    ``gated_ff=False`` gives it the non-gated ``FeedForward``."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None,
                 gated_ff: bool = True, disable_self_attn: bool = False,
                 tome_ratio: float = 0.0, tome_sx: int = 2, tome_sy: int = 2,
                 tome_seed: Optional[int] = None, dtype=None, device=None):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.tome_ratio, self.tome_sx, self.tome_sy, self.tome_seed = (
            tome_ratio, tome_sx, tome_sy, tome_seed)
        self.attn1 = CrossAttention(dim, context_dim if disable_self_attn else None, n_heads,
                                    d_head, dtype=dtype, device=device)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, dtype=dtype,
                                    device=device)
        self.ff = FeedForward(dim, glu=gated_ff, dtype=dtype, device=device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5, device=device)

    @staticmethod
    def _ln(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
        # f32 LayerNorm, as the JAX package's f32-param LayerNorm computes it
        return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        h = self._ln(self.norm1, x)
        if self.disable_self_attn:
            x = self.attn1(h, context=context) + x
        else:
            r = 0
            if self.tome_ratio > 0 and hw is not None:
                r = tome_r(x.shape[1], self.tome_ratio, *hw, self.tome_sx, self.tome_sy)
            if r > 0:
                merge, unmerge = bipartite_soft_matching_2d(
                    x, *hw, sx=self.tome_sx, sy=self.tome_sy, r=r, seed=self.tome_seed)
                x = unmerge(self.attn1(merge(h))) + x
            else:
                x = self.attn1(h) + x
        x = self.attn2(self._ln(self.norm2, x), context=context) + x
        x = self.ff(self._ln(self.norm3, x)) + x
        return x


class SpatialTransformer(nn.Module):
    """(reference: models/stablediffusion/attention.py:231-285)

    GroupNorm (eps 1e-6) -> 1x1 proj_in -> ``depth`` transformer blocks over
    the H*W tokens -> zero-initialised 1x1 proj_out, plus the residual.  With
    ``use_linear`` (SDXL) the tokens are flattened first and ``proj_in`` /
    ``proj_out`` are ``nn.Linear`` layers on them (upstream keys, [C_out,
    C_in] weights), in the order of ``dmtpu/models/stablediffusion/
    attention.py:153-180``.  ``disable_self_attn`` makes every block's
    ``attn1`` a cross-attention.  The ``tome_*`` options go to every block
    (``BasicTransformerBlock``).
    """

    takes_context = True  # a UNet block hands it the context

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, disable_self_attn: bool = False,
                 use_linear: bool = False, tome_ratio: float = 0.0, tome_sx: int = 2,
                 tome_sy: int = 2, tome_seed: Optional[int] = None, dtype=None, device=None):
        super().__init__()
        inner = n_heads * d_head
        self.use_linear = use_linear
        self.norm = GroupNorm32(in_channels, eps=1e-6, device=device)
        if use_linear:
            self.proj_in = Linear(in_channels, inner, dtype=dtype, device=device)
        else:
            self.proj_in = Conv2d(in_channels, inner, 1, dtype=dtype, device=device)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim=context_dim,
                                  disable_self_attn=disable_self_attn,
                                  tome_ratio=tome_ratio, tome_sx=tome_sx, tome_sy=tome_sy,
                                  tome_seed=tome_seed, dtype=dtype, device=device)
            for _ in range(depth))
        if use_linear:
            self.proj_out = Linear(inner, in_channels, dtype=dtype, device=device)
        else:
            self.proj_out = Conv2d(inner, in_channels, 1, dtype=dtype, device=device)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        x_in = x
        x = self.norm(x)
        if not self.use_linear:
            x = self.proj_in(x)
        x = x.flatten(2).transpose(1, 2)  # [B, H*W, channels]
        if self.use_linear:
            x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, context=context, hw=(h, w))
        if self.use_linear:
            return self.proj_out(x).transpose(1, 2).reshape(b, c, h, w) + x_in
        x = x.transpose(1, 2).reshape(b, x.shape[2], h, w)
        return self.proj_out(x) + x_in
