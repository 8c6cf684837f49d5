"""The building blocks of the repo's own pixel-space UNets, in NCHW.

Counterpart of ``dmtpu/models/modules.py`` (reference: models/modules.py):
``Conv``, ``Dense``, ``SinusoidalPosEmb``, ``Upsample``, ``Downsample``,
``SelfAttentionBlock``, ``AdaGN`` and ``FusedGNSiLU``, with the JAX
package's names.  ``Conv`` and ``Dense`` keep the Flax wrappers' inner
module (``conv``, ``dense``), so their keys are the JAX package's
(``first_conv.conv.weight``).  ``SelfAttentionBlock`` stores q, k, v and
proj as the reference's 1x1 convolutions (``q.weight`` [C, C, 1, 1]); the
JAX package stores them as dense layers, and ``convert.load_flax_params``
maps one onto the other.

Every GroupNorm goes through ``dmtpu_torch.ops.group_norm`` (K3 on a CUDA
tensor), with f32 statistics and the output in the input's dtype, fused
with the SiLU that follows it where there is one; the attention goes through
``dmtpu_torch.ops.attention`` (K1 on a CUDA tensor).  ``dtype`` is the
torso's compute dtype, as the JAX modules' ``dtype``: parameters stay f32.
The initialisation is PyTorch's layer default, which the JAX package
reproduces.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.models.adm import Conv2d, Linear, image_of, pointwise, tokens_of
from dmtpu_torch.ops.attention import attention
from dmtpu_torch.ops.groupnorm import group_norm


class Conv(nn.Module):
    """A convolution under the Flax wrapper's name ``conv``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, use_bias: bool = True, dtype: Any = None, device: Any = None):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size, stride=stride, padding=padding,
                           bias=use_bias, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Dense(nn.Module):
    """A dense layer under the Flax wrapper's name ``dense``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True, dtype: Any = None,
                 device: Any = None):
        super().__init__()
        self.dense = Linear(in_features, features, bias=use_bias, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with f32 parameters and statistics, the output in the
    input's dtype; ``silu=True`` fuses the SiLU that follows it."""

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, silu)


class SinusoidalPosEmb(nn.Module):
    """Transformer sinusoidal timestep embedding, sin first, with f64 host
    frequencies cast to f32.  (reference: models/modules.py:40-57)"""

    def __init__(self, dim: int, device: Any = None):
        super().__init__()
        self.dim = dim
        half = dim // 2
        freqs = np.exp(-math.log(10000) / (half - 1) * np.arange(half, dtype=np.float64))
        self.register_buffer("freqs", torch.from_numpy(freqs.astype(np.float32)).to(device),
                             persistent=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = t.float()[:, None] * self.freqs.to(t.device)[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def nearest_up(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsampling."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    """2x nearest upsample, optional 3x3 conv.  (reference: models/modules.py:60-66)"""

    def __init__(self, in_channels: int, out_channels: int, use_conv: bool = True,
                 dtype: Any = None, device: Any = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = Conv(in_channels, out_channels, 3, 1, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nearest_up(x)
        return self.conv(x) if self.use_conv else x


class Downsample(nn.Module):
    """Stride-2 3x3 conv, or 2x2 average pooling.  (reference: models/modules.py:69-74)"""

    def __init__(self, in_channels: int, out_channels: int, use_conv: bool = True,
                 dtype: Any = None, device: Any = None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = Conv(in_channels, out_channels, 3, 2, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) if self.use_conv else F.avg_pool2d(x, 2)


class SelfAttentionBlock(nn.Module):
    """GroupNorm -> q, k, v -> attention over the H*W tokens -> proj,
    residual.  (reference: models/modules.py:77-102; scale hd**-0.5, f32
    softmax)"""

    def __init__(self, dim: int, n_heads: int = 1, groups: int = 32, dtype: Any = None,
                 device: Any = None):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} is not a multiple of n_heads {n_heads}")
        self.n_heads = n_heads
        self.norm = GroupNorm(groups, dim, eps=1e-5, device=device)
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, Conv2d(dim, dim, 1, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = tokens_of(self.norm(x))
        q, k, v = (pointwise(conv, tokens).reshape(b, h * w, self.n_heads, c // self.n_heads)
                   for conv in (self.q, self.k, self.v))
        out = attention(q, k, v)
        out = pointwise(self.proj, out.reshape(b, h * w, c))
        return image_of(out, h, w) + x


class AdaGN(nn.Module):
    """Adaptive GroupNorm: ``gn(x) * (1 + ys) + yb`` with (ys, yb) a dense
    layer of the embedding; f32.  (reference: models/modules.py:105-123)
    ``silu=True`` applies the SiLU that follows it."""

    def __init__(self, num_groups: int, num_channels: int, embed_dim: int, device: Any = None):
        super().__init__()
        self.proj = Dense(embed_dim, num_channels * 2, device=device)
        self.gn = GroupNorm(num_groups, num_channels, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, embed: torch.Tensor, silu: bool = False) -> torch.Tensor:
        ys, yb = self.proj(F.silu(embed)).chunk(2, dim=-1)
        h = self.gn(x).float() * (1.0 + ys[:, :, None, None]) + yb[:, :, None, None]
        return (F.silu(h) if silu else h).to(x.dtype)


class FusedGNSiLU(nn.Module):
    """GroupNorm(+SiLU) through K3, with ``nn.GroupNorm``'s parameters
    (the JAX package's Pallas kernel behind the CIFAR UNet's ``fused_gn``)."""

    def __init__(self, channels: int, groups: int = 32, silu: bool = True, eps: float = 1e-5,
                 device: Any = None):
        super().__init__()
        self.groups, self.silu, self.eps = groups, silu, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.groups, self.eps, self.silu)
