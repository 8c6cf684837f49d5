"""Latent-space wrapper for DiT / MDT: a VAE and a ViT denoiser.

Counterpart of ``dmtpu/models/latent.py`` (reference: models/dit/dit.py:10-33
and models/mdt/mdt.py:10-33): ``decode_latent(z) = vae.decode(z /
scale_factor)``; the denoiser is the wrapped ViT.  The reference pulls its
VAE from diffusers (``stabilityai/sd-vae-ft-ema``); ``PretrainedVAE`` builds
the same CompVis ``AutoencoderKL`` and records the path, and diffusers-named
VAE weights are renamed by ``dmtpu_torch.convert.sd.diffusers_vae_to_compvis``
when they are loaded.  Where the JAX wrapper is functional over one params
dict ``{"vit", "vae"}``, this one is an ``nn.Module`` that owns both parts,
so its methods take no ``params``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from dmtpu_torch.models.stablediffusion.autoencoder import AutoencoderKL
from dmtpu_torch.utils import profiling


def PretrainedVAE(from_pretrained: Optional[str] = None, **kwargs: Any) -> AutoencoderKL:
    """The diffusers sd-vae-ft-ema / -mse architecture, which is SD's
    AutoencoderKL; ``from_pretrained`` is recorded for the caller, which
    loads the weights from a local file (no download)."""
    vae = AutoencoderKL(**kwargs)
    vae.from_pretrained = from_pretrained
    return vae


class LatentDiffusionWrapper(nn.Module):
    """VAE + ViT latent diffusion model (DiT / MDT)."""

    def __init__(self, vae_config: Optional[Dict] = None, vit_config: Optional[Dict] = None,
                 scale_factor: float = 0.18215, device: Any = None, **_: Any):
        super().__init__()
        from dmtpu_torch.utils.config import instantiate_from_config

        self.scale_factor = float(scale_factor)
        self.vae: AutoencoderKL = (instantiate_from_config(vae_config, device=device)
                                   if vae_config else PretrainedVAE(device=device))
        self.vit = instantiate_from_config(vit_config, device=device) if vit_config else None

    def load_state_dict(self, state_dict: Mapping[str, Any],
                        vae_sd: Optional[Mapping[str, Any]] = None, strict: bool = True,
                        **kwargs: Any):
        """The ViT's weights from an upstream DiT / MDT checkpoint (its
        rebuilt buffers, ``pos_embed`` of DiT and ``relative_position_index``,
        dropped), and the VAE's from ``vae_sd`` (CompVis or diffusers names)
        when given.  A dict in this module's own layout (``vit.``, ``vae.``)
        loads as with any ``nn.Module``.  Returns self."""
        if vae_sd is None and any(k.startswith(("vit.", "vae.")) for k in state_dict):
            super().load_state_dict(state_dict, strict=strict, **kwargs)
            return self
        self.vit.load_upstream(state_dict, strict=strict)
        if vae_sd is not None:
            from dmtpu_torch.convert.sd import diffusers_vae_to_compvis

            if any(k.startswith("encoder.down_blocks") for k in vae_sd):
                vae_sd = diffusers_vae_to_compvis(vae_sd)
            self.vae.load_state_dict({k: torch.as_tensor(v) for k, v in vae_sd.items()},
                                     strict=strict)
        return self

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z.float() / self.scale_factor)

    def vit_forward(self, x: torch.Tensor, t: torch.Tensor,
                    y: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.vit(x, t, y)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.vit_forward(x, t, y)

    def make_model_fn(self) -> Callable[..., torch.Tensor]:
        """model_fn(x, t, y=None) for the samplers; each call a ``denoiser``
        span while a profiler records."""

        def model_fn(x, t, y=None, **kw):
            with profiling.span("denoiser", device=True):
                return self.vit_forward(x, t, y)

        return model_fn
