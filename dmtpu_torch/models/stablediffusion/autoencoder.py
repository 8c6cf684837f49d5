"""Stable Diffusion AutoencoderKL (the CompVis first-stage VAE), in NCHW.

Counterpart of ``dmtpu/models/stablediffusion/autoencoder.py`` (reference:
models/stablediffusion/autoencoder.py: Encoder :280-375, Decoder :377-487,
AutoEncoderKL :486-537; DiagonalGaussianDistribution in
distributions.py:24-61).  Submodule names are the upstream torch ones
(``encoder.down.0.block.1.norm1``, ``decoder.up.3.upsample.conv``,
``quant_conv``, ...), so a CompVis ``first_stage_model.`` state dict loads
as it is; ``dmtpu_torch.convert.sd.diffusers_vae_to_compvis`` rewrites the
diffusers layout.

Parameters and arithmetic are f32.  Every GroupNorm runs through
``dmtpu_torch.ops.group_norm`` (K3 on the card), the mid-block attention
through the plain ``mha`` (see ``dmtpu_torch.models.pesser``).  Moments and
latents are [B, C, H, W]: the moments split on dim 1.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from dmtpu_torch.models.adm import Conv2d
from dmtpu_torch.models.pesser import _AttnBlock, _Downsample, _Upsample, _norm
from dmtpu_torch.utils import rows


class _VAEResnetBlock(nn.Module):
    """ResnetBlock without a time embedding (no ``temb_proj``)."""

    def __init__(self, in_channels: int, out_channels: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.norm1 = _norm(in_channels, device)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, device=device)
        self.norm2 = _norm(out_channels, device)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, device=device)
        if in_channels != out_channels:
            self.nin_shortcut = Conv2d(in_channels, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


def _mid(channels: int, dropout: float, device) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = _VAEResnetBlock(channels, channels, dropout, device)
    mid.attn_1 = _AttnBlock(channels, device)
    mid.block_2 = _VAEResnetBlock(channels, channels, dropout, device)
    return mid


def _run_level(level: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """The ResNet blocks of one resolution level, each followed by its
    attention where the level has any."""
    for j, block in enumerate(level.block):
        h = block(h)
        if len(level.attn):
            h = level.attn[j](h)
    return h


class Encoder(nn.Module):
    """(reference: models/stablediffusion/autoencoder.py:280-375)"""

    def __init__(self, ch: int, z_channels: int, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, in_channels: int = 3, double_z: bool = True,
                 dropout: float = 0.0, device=None):
        super().__init__()
        nres = len(ch_mult)
        curr_res = resolution
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1, device=device)
        self.down = nn.ModuleList()
        block_in = ch
        for i in range(nres):
            block_out = ch * ch_mult[i]
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(_VAEResnetBlock(block_in, block_out, dropout, device))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(_AttnBlock(block_in, device))
            if i != nres - 1:
                level.downsample = _Downsample(block_in, True, device)
                curr_res //= 2
            self.down.append(level)
        self.mid = _mid(block_in, dropout, device)
        self.norm_out = _norm(block_in, device)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels, 3,
                               padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = _run_level(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    """(reference: models/stablediffusion/autoencoder.py:377-487)"""

    def __init__(self, ch: int, out_ch: int, z_channels: int,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), resolution: int = 256,
                 tanh_out: bool = False, dropout: float = 0.0, device=None):
        super().__init__()
        nres = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (nres - 1)
        self.tanh_out = tanh_out
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1, device=device)
        self.mid = _mid(block_in, dropout, device)
        levels = []
        for i in reversed(range(nres)):
            block_out = ch * ch_mult[i]
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(_VAEResnetBlock(block_in, block_out, dropout, device))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(_AttnBlock(block_in, device))
            if i != 0:
                level.upsample = _Upsample(block_in, True, device)
                curr_res *= 2
            levels.insert(0, level)  # up.0 is the finest level, as upstream
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(block_in, device)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            h = _run_level(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = self.conv_out(self.norm_out(h, silu=True))
        return torch.tanh(h) if self.tanh_out else h


class DiagonalGaussianDistribution:
    """(reference: models/stablediffusion/distributions.py:24-61); the
    moments are [B, 2C, H, W]: mean and log-variance on dim 1."""

    def __init__(self, moments: torch.Tensor, deterministic: bool = False):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * noise, the noise drawn from ``generator``."""
        if self.deterministic:
            return self.mean
        noise = rows.randn(self.mean.shape, generator, self.mean.device, self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros((), device=self.mean.device)
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=(1, 2, 3))
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var
            + self.var / other.var - 1.0 - self.logvar + other.logvar, dim=(1, 2, 3))


class AutoencoderKL(nn.Module):
    """(reference: models/stablediffusion/autoencoder.py:486-537)"""

    def __init__(self, embed_dim: int = 4, z_channels: int = 4, resolution: int = 256,
                 in_channels: int = 3, out_ch: int = 3, ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), dropout: float = 0.0,
                 double_z: bool = True,        # accepted for config parity, as in the JAX module
                 attn_type: str = "vanilla",   # likewise: vanilla-xformers computes the same
                 device=None):
        super().__init__()
        self.in_channels = in_channels
        self.encoder = Encoder(ch=ch, z_channels=z_channels, ch_mult=ch_mult,
                               num_res_blocks=num_res_blocks, attn_resolutions=attn_resolutions,
                               resolution=resolution, in_channels=in_channels, dropout=dropout,
                               device=device)
        self.decoder = Decoder(ch=ch, out_ch=out_ch, z_channels=z_channels, ch_mult=ch_mult,
                               num_res_blocks=num_res_blocks, attn_resolutions=attn_resolutions,
                               resolution=resolution, dropout=dropout, device=device)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, 1, device=device)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1, device=device)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        return DiagonalGaussianDistribution(self.encode_moments(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.encode_moments(x)
        posterior = DiagonalGaussianDistribution(moments)
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        return self.decode(z), moments
