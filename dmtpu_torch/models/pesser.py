"""The pesser/CompVis building blocks the Stable Diffusion VAE uses, in NCHW.

Counterpart of ``dmtpu/models/pesser.py`` (reference:
models/pesser/model.py:38-327): the eps-1e-6 GroupNorm, ``_ResnetBlock``,
the single-head ``_AttnBlock`` with 1x1-conv projections, the
asymmetrically padded stride-2 ``_Downsample`` and the nearest-neighbour
``_Upsample``, which the Stable Diffusion VAE uses too, and ``PesserUNet``,
pesser/pytorch_diffusion's DDPM UNet (the CelebA-HQ / LSUN 256 releases).
Submodule names are the upstream torch ones (``temb.dense.0``,
``down.0.block.1``, ``mid.attn_1``, ``norm1``, ``conv1``, ``temb_proj``,
``nin_shortcut``, ``q``, ``proj_out``, ...).

Every GroupNorm goes through ``dmtpu_torch.ops.group_norm`` (K3 on a CUDA
tensor), fused with the SiLU that follows it where there is one.  The
attention is the plain ``mha``, as in the JAX module: one head as wide as
the channel count is outside what the attention kernels take.  Parameters
and arithmetic are f32 (the JAX modules pass no ``dtype``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.models.adm import Conv2d, GroupNorm32
from dmtpu_torch.models.modules import SinusoidalPosEmb
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
        self.dropout = dropout
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, device=device)
        if in_channels != out_channels:
            if conv_shortcut:
                self.conv_shortcut = Conv2d(in_channels, out_channels, 3, padding=1,
                                            device=device)
            else:
                self.nin_shortcut = Conv2d(in_channels, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, *, train: bool = False
                ) -> torch.Tensor:
        """Dropout only under ``train=True``, whatever the module's mode."""
        h = self.conv1(self.norm1(x, silu=True))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.dropout(self.norm2(h, silu=True), self.dropout, train))
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


class PesserUNet(nn.Module):
    """(reference: models/pesser/model.py:190-327)"""

    def __init__(self, ch: int, out_ch: int, num_res_blocks: int,
                 attn_resolutions: Sequence[int], in_channels: int, resolution: int,
                 ch_mult: Sequence[int] = (1, 2, 4, 8), dropout: float = 0.0,
                 resamp_with_conv: bool = True, device=None):
        super().__init__()
        self.resolution, self.in_channels, self.out_channels = resolution, in_channels, out_ch
        temb_ch = ch * 4
        self.temb_pos = SinusoidalPosEmb(ch, device=device)
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch, device=device),
                                         nn.Linear(temb_ch, temb_ch, device=device)])
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, device=device)
        in_ch_mult = (1,) + tuple(ch_mult)
        curr_res, chans = resolution, [ch]
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_in = ch * in_ch_mult[i]
            for _ in range(num_res_blocks):
                level.block.append(_ResnetBlock(block_in, ch * mult, temb_ch, dropout,
                                                device=device))
                block_in = ch * mult
                if curr_res in attn_resolutions:
                    level.attn.append(_AttnBlock(block_in, device=device))
                chans.append(block_in)
            if i != len(ch_mult) - 1:
                level.downsample = _Downsample(block_in, resamp_with_conv, device=device)
                curr_res //= 2
                chans.append(block_in)
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = _ResnetBlock(block_in, block_in, temb_ch, dropout, device=device)
        self.mid.attn_1 = _AttnBlock(block_in, device=device)
        self.mid.block_2 = _ResnetBlock(block_in, block_in, temb_ch, dropout, device=device)
        up = []
        for i in reversed(range(len(ch_mult))):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(_ResnetBlock(block_in + chans.pop(), ch * ch_mult[i], temb_ch,
                                                dropout, device=device))
                block_in = ch * ch_mult[i]
                if curr_res in attn_resolutions:
                    level.attn.append(_AttnBlock(block_in, device=device))
            if i != 0:
                level.upsample = _Upsample(block_in, resamp_with_conv, device=device)
                curr_res *= 2
            up.insert(0, level)  # ``up.{i}`` is level i, as upstream
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(block_in, device)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """``train`` turns the ResNet blocks' dropout on (the JAX module's keyword)."""
        if x.shape[2] != self.resolution or x.shape[3] != self.resolution:
            raise ValueError(f"PesserUNet({self.resolution}) got images of {tuple(x.shape[2:])}")
        temb = self.temb.dense[0](self.temb_pos(t))
        temb = self.temb.dense[1](F.silu(temb))
        hs = [self.conv_in(x)]
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(hs[-1], temb, train=train)
                if len(level.attn):
                    h = level.attn[j](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))
        h = self.mid.block_1(hs[-1], temb, train=train)
        h = self.mid.block_2(self.mid.attn_1(h), temb, train=train)
        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb, train=train)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True))
