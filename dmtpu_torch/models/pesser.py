"""The pesser/CompVis building blocks the Stable Diffusion VAE uses, in NCHW.

Counterpart of the part of ``dmtpu/models/pesser.py`` that
``dmtpu/models/stablediffusion/autoencoder.py`` imports (reference:
models/pesser/model.py:38-187): the eps-1e-6 GroupNorm, ``_ResnetBlock``,
the single-head ``_AttnBlock`` with 1x1-conv projections, the
asymmetrically padded stride-2 ``_Downsample`` and the nearest-neighbour
``_Upsample``.  Submodule names are the upstream torch ones (``norm1``,
``conv1``, ``temb_proj``, ``nin_shortcut``, ``q``, ``proj_out``, ...).

Every GroupNorm goes through ``dmtpu_torch.ops.group_norm`` (K3 on a CUDA
tensor), fused with the SiLU that follows it where there is one.  The
attention is the plain ``mha``, as in the JAX module: one head as wide as
the channel count is outside what the attention kernels take.  Parameters
and arithmetic are f32 (the JAX modules pass no ``dtype``).

``PesserUNet`` itself (``dmtpu/models/pesser.py:99``) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.models.adm import Conv2d, GroupNorm32
from dmtpu_torch.ops.attention import mha


def _norm(channels: int, device=None) -> GroupNorm32:
    """GroupNorm(32, eps 1e-6)."""
    return GroupNorm32(channels, eps=1e-6, device=device)


class _ResnetBlock(nn.Module):
    """(reference: models/pesser/model.py:76-133)"""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int = 512,
                 dropout: float = 0.0, conv_shortcut: bool = False, device=None):
        super().__init__()
        self.norm1 = _norm(in_channels, device)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, device=device)
        self.temb_proj = nn.Linear(temb_channels, out_channels, device=device)
        self.norm2 = _norm(out_channels, device)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, device=device)
        if in_channels != out_channels:
            if conv_shortcut:
                self.conv_shortcut = Conv2d(in_channels, out_channels, 3, padding=1,
                                            device=device)
            else:
                self.nin_shortcut = Conv2d(in_channels, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.dropout(self.norm2(h, silu=True)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        elif hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class _AttnBlock(nn.Module):
    """Single-head attention with 1x1-conv projections.
    (reference: models/pesser/model.py:136-187)"""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.norm = _norm(channels, device)
        self.q = Conv2d(channels, channels, 1, device=device)
        self.k = Conv2d(channels, channels, 1, device=device)
        self.v = Conv2d(channels, channels, 1, device=device)
        self.proj_out = Conv2d(channels, channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)
        # [B, C, H, W] -> [B, H*W, 1, C]: one head over all channels
        q, k, v = (conv(hn).reshape(b, c, h * w).transpose(1, 2).unsqueeze(2)
                   for conv in (self.q, self.k, self.v))
        out = mha(q, k, v, scale=c ** -0.5)
        out = out.squeeze(2).transpose(1, 2).reshape(b, c, h, w)
        return x + self.proj_out(out)


class _Downsample(nn.Module):
    """Pad one row below and one column to the right, then a stride-2 conv
    with no padding of its own.  (reference: models/pesser/model.py:55-72)"""

    def __init__(self, channels: int, with_conv: bool = True, device=None):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = Conv2d(channels, channels, 3, stride=2, padding=0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.with_conv:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2)


class _Upsample(nn.Module):
    """Nearest-neighbour x2, then a 3x3 conv.  (reference: models/pesser/model.py:38-52)"""

    def __init__(self, channels: int, with_conv: bool = True, device=None):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if self.with_conv else x
