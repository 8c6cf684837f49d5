"""The ADM (guided-diffusion) building blocks the SD UNet uses, in NCHW.

Counterpart of the part of ``dmtpu/models/adm.py`` that
``dmtpu/models/stablediffusion/unet.py`` imports: ``timestep_embedding``,
GroupNorm32, ``_zeros_conv``, ``_Upsample``, ``_Downsample`` and
``ResBlock`` (reference: models/adm/unet.py:97-276, models/adm/nn.py).
Module and parameter names are the upstream torch ones (``in_layers.0``,
``emb_layers.1``, ``out_layers.3``, ...), so upstream state dicts load as
they are, even where ``forward`` fuses a GroupNorm and its SiLU into one
``group_norm`` call.

Torso dtype: the JAX package computes the torso's convolutions and dense
layers in ``torso_dtype`` (bf16) from f32 params (Flax ``dtype`` with f32
``param_dtype``).  Here too the torso's ``Conv2d`` and ``Linear`` hold f32
parameters and cast input, weight and bias to ``torso_dtype`` in
``forward``, as Flax's ``promote_dtype`` does, so a gradient reaches the f32
parameter and an optimizer step smaller than a bf16 ulp is kept.
GroupNorm and LayerNorm params stay f32 and normalise in f32.  A module
that has the JAX package's ``param_dtype`` (MMDiT) passes it on as
``Linear`` / ``Conv2d``'s ``param_dtype``: the storage dtype, f32 unless
given.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.ops.groupnorm import group_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """ADM sinusoidal embedding: cos-first, freqs = exp(-ln(P)·i/half), with
    f64 host freqs cast to f32 and an f32 product (reference: models/adm/nn.py:103-122)."""
    half = dim // 2
    freqs = np.exp(-math.log(max_period) * np.arange(half, dtype=np.float64) / half)
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(timesteps.device)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def resolve_torso_dtype(torso_dtype, use_fp16: bool = False, use_bf16: bool = False):
    """The torso dtype of a config: ``torso_dtype`` (a ``torch.dtype`` or its
    name) where given, else bf16 for the reference's ``use_fp16`` /
    ``use_bf16`` switches, else None (f32).  Counterpart of
    ``dmtpu/models/adm.py::resolve_torso_dtype``: an fp16 config computes in
    bf16 here too."""
    if isinstance(torso_dtype, str):  # a YAML config names the dtype
        torso_dtype = getattr(torch, torso_dtype)
    if torso_dtype is not None:
        return torso_dtype
    return torch.bfloat16 if use_fp16 or use_bf16 else None


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with parameters stored in ``param_dtype`` (f32 when None)
    that computes in ``dtype`` (the torso dtype; f32 when None): input,
    weight and bias are cast to it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None, device=None, param_dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with parameters stored in ``param_dtype`` (f32 when None)
    that computes in ``dtype`` (the torso dtype; f32 when None): input,
    weight and bias are cast to it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype=None, device=None, param_dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, device=device, dtype=param_dtype)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class GroupNorm32(nn.GroupNorm):
    """32 groups, f32 params and math, the output in the input's dtype
    (reference: models/adm/nn.py GroupNorm32).  ``silu=True`` fuses the SiLU
    that follows it into the same ``group_norm`` call."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__(32, channels, eps=eps, device=device)

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, silu)


def _zeros_conv(in_ch: int, out_ch: int, kernel: int, padding: int = 1, dtype=None,
                device=None) -> Conv2d:
    """zero_module'd conv (reference: models/adm/nn.py:68-74)."""
    conv = Conv2d(in_ch, out_ch, kernel, padding=padding, dtype=dtype, device=device)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class _Upsample(nn.Module):
    """(reference: models/adm/unet.py:97-130)"""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True, dtype=None, device=None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = Conv2d(channels, out_channels or channels, 3, padding=1,
                               dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if self.use_conv else x


class _Downsample(nn.Module):
    """(reference: models/adm/unet.py:132-159)"""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True, dtype=None, device=None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = Conv2d(channels, out_channels or channels, 3, stride=2, padding=1,
                             dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x) if self.use_conv else F.avg_pool2d(x, 2)


class ResBlock(nn.Module):
    """(reference: models/adm/unet.py:162-276)

    ``in_layers`` = (GroupNorm32, SiLU, conv), ``emb_layers`` = (SiLU,
    Linear), ``out_layers`` = (GroupNorm32, SiLU, Dropout, zero conv); each
    GroupNorm+SiLU pair runs as one fused op.
    """

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 dropout: float = 0.0, use_conv: bool = False,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False,
                 dtype=None, device=None):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, device=device), nn.SiLU(),
            Conv2d(channels, out_ch, 3, padding=1, dtype=dtype, device=device))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch,
                              dtype=dtype, device=device))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch, device=device), nn.SiLU(), nn.Dropout(dropout),
            _zeros_conv(out_ch, out_ch, 3, dtype=dtype, device=device))
        if out_ch == channels:
            self.skip_connection = nn.Identity()
        elif use_conv:
            self.skip_connection = Conv2d(channels, out_ch, 3, padding=1, dtype=dtype,
                                          device=device)
        else:
            self.skip_connection = Conv2d(channels, out_ch, 1, dtype=dtype, device=device)

    def _updown(self, z: torch.Tensor) -> torch.Tensor:
        if self.up:
            return F.interpolate(z, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(z, 2)
        return z

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[0](x, silu=True)
        if self.up or self.down:
            h, x = self._updown(h), self._updown(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](F.silu(emb)).to(h.dtype)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        else:
            h = self.out_layers[0](h + emb_out, silu=True)
        h = self.out_layers[3](self.out_layers[2](h))
        return self.skip_connection(x) + h
