"""Stable Diffusion 1.5 / 2.1 latent text-to-image stack.

``StableDiffusion`` composes the CLIP text encoder, the AutoencoderKL and the
cross-attention UNet (reference: models/stablediffusion/stablediffusion.py:
12-79).  Counterpart of ``dmtpu/models/stablediffusion/__init__.py``; where
the JAX wrapper is functional over one params dict ``{"unet", "vae",
"text_encoder"}``, this one is an ``nn.Module`` that owns its three parts, so
its methods take no ``params``.  A CompVis ``.ckpt`` / ``.safetensors`` loads
natively: the modules carry the upstream keys, and
``dmtpu_torch.convert.sd.split_sd_checkpoint`` only splits the prefixes.
``set_tome`` / ``set_freeu`` switch the UNet's serving accelerators; the
parameters stay as they are.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from dmtpu_torch.models.stablediffusion.attention import SpatialTransformer
from dmtpu_torch.models.stablediffusion.autoencoder import (
    AutoencoderKL,
    Decoder,
    DiagonalGaussianDistribution,
    Encoder,
)
from dmtpu_torch.models.stablediffusion.text_encoders import (
    CLIPTextTransformer,
    FrozenCLIPEmbedder,
    FrozenCLIPT5Encoder,
    FrozenOpenCLIPEmbedder,
    FrozenT5Embedder,
)
from dmtpu_torch.models.stablediffusion.unet import SDUNetModel
from dmtpu_torch.utils import profiling

__all__ = [
    "StableDiffusion",
    "SDUNetModel",
    "AutoencoderKL",
    "Encoder",
    "Decoder",
    "DiagonalGaussianDistribution",
    "SpatialTransformer",
    "CLIPTextTransformer",
    "FrozenCLIPEmbedder",
    "FrozenOpenCLIPEmbedder",
    "FrozenT5Embedder",
    "FrozenCLIPT5Encoder",
    "load_owned_",
    "seeded_init_",
]

_COMPVIS_PREFIXES = ("model.diffusion_model.", "first_stage_model.", "cond_stage_model.")


def load_owned_(tower: nn.Module, state_dict: Mapping[str, Any], strict: bool = True) -> None:
    """Load the leaves of ``state_dict`` that ``tower`` owns.  An open_clip
    tower carries its pooled path (``text_projection``) and ``logit_scale``
    whether or not this tower has them: they are dropped, as the JAX
    converter loads a tower non-strictly; a missing leaf still raises."""
    own = tower.state_dict()
    tower.load_state_dict({k: v for k, v in state_dict.items() if k in own}, strict=strict)


def seeded_init_(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Seeded random parameters in place, each drawn on its own device:
    N(0, 1/fan_in) weights and embeddings, unit norm scales, zero biases;
    the layers the modules zero-initialise stay zero, as in the JAX
    package's ``init``."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            elif p.any():  # a weight the constructor left all zero stays zero
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
                        * p[0].numel() ** -0.5)
    return module


class StableDiffusion(nn.Module):
    """The SD stack, instantiable from the reference's weight YAMLs."""

    def __init__(
        self,
        text_encoder_config: Optional[Dict] = None,
        vae_config: Optional[Dict] = None,
        unet_config: Optional[Dict] = None,
        scale_factor: float = 0.18215,
        low_vram_shift_enabled: bool = False,  # accepted for config parity
        device: Any = None,
        **_: Any,
    ):
        super().__init__()
        from dmtpu_torch.utils.config import instantiate_from_config

        self.scale_factor = float(scale_factor)
        self.text_encoder = (instantiate_from_config(text_encoder_config, device=device)
                             if text_encoder_config else FrozenCLIPEmbedder(device=device))
        self.vae: AutoencoderKL = (instantiate_from_config(vae_config, device=device)
                                   if vae_config else AutoencoderKL(device=device))
        self.unet: Optional[SDUNetModel] = (
            instantiate_from_config(unet_config, device=device) if unet_config else None)

    # --- loading -------------------------------------------------------
    def load_state_dict(self, state_dict: Mapping[str, Any],
                        text_encoder_sd: Optional[Mapping[str, Any]] = None,
                        strict: bool = True, **kwargs: Any):
        """Load a CompVis-format checkpoint (keys under
        ``model.diffusion_model.``, ``first_stage_model.`` and
        ``cond_stage_model.``; ``text_encoder_sd`` optionally gives the text
        tower apart, in the HF or the open_clip layout; leaves the text tower
        does not own, such as an open_clip ``text_projection`` beside a tower
        without one, are left out).  A dict in this
        module's own layout (``unet.``, ``vae.``, ``text_encoder.``) loads as
        with any ``nn.Module``."""
        if text_encoder_sd is None and \
                not any(k.startswith(_COMPVIS_PREFIXES) for k in state_dict):
            return super().load_state_dict(state_dict, strict=strict, **kwargs)
        from dmtpu_torch.convert.sd import split_sd_checkpoint

        parts = split_sd_checkpoint(state_dict, text_encoder_sd)
        as_tensors = {name: None if part is None else
                      {k: torch.as_tensor(v) for k, v in part.items()}
                      for name, part in parts.items()}
        self.unet.load_state_dict(as_tensors["unet"], strict=strict)
        self.vae.load_state_dict(as_tensors["vae"], strict=strict)
        if as_tensors["text_encoder"] is not None:
            load_owned_(self.text_encoder.model, as_tensors["text_encoder"], strict)
        return self

    def load_weights(self, path: str) -> "StableDiffusion":
        """Load a CompVis-format ``.ckpt`` / ``.safetensors`` (the state dict
        at the top, or under ``state_dict``, ``ema.shadow`` or ``model``), a
        torch file in this module's own layout (what ``merge_lora`` writes),
        or the JAX package's ``.npz`` (``params``: ``{"unet", "vae",
        "text_encoder"}``, what the JAX ``merge_lora`` writes; reference:
        utils/load.py:7-19)."""
        from dmtpu_torch.scripts._common import load_npz_params, load_torch_weights

        if path.endswith(".npz"):
            from dmtpu_torch.convert.flax_bridge import load_flax_params

            params = load_npz_params(path)
            load_flax_params(self.unet, params["unet"])
            load_flax_params(self.vae, params["vae"])
            if params.get("text_encoder") is not None:
                load_flax_params(self.text_encoder.model, params["text_encoder"])
            return self
        if not path.endswith((".safetensors", ".ckpt", ".pt", ".pth")):
            raise ValueError(f"unsupported weights file {path!r}: expected .ckpt, .pt, "
                             ".safetensors or .npz")
        self.load_state_dict(load_torch_weights(path))
        return self

    def init_params(self, generator: Optional[torch.Generator] = None,
                    img_size: int = 64) -> "StableDiffusion":
        """Seeded random parameters, for demos and tests without a checkpoint
        (``seeded_init_``).  ``img_size`` is accepted for parity (no
        parameter's shape depends on it)."""
        seeded_init_(self, generator)
        return self

    _UNSET = object()

    def set_tome(self, ratio: float, sx: Any = _UNSET, sy: Any = _UNSET,
                 max_downsample: Any = _UNSET, seed: Any = _UNSET) -> "StableDiffusion":
        """Token Merging on the UNet at ``ratio`` (0 = off); the knobs left
        unspecified keep their current values (``set_tome(0.6)`` after
        ``set_tome(0.5, seed=3)`` changes only the ratio).  No parameter
        changes.  Returns self."""
        u, unset = self.unet, self._UNSET
        u.set_tome(ratio, u.tome_sx if sx is unset else sx, u.tome_sy if sy is unset else sy,
                   u.tome_max_downsample if max_downsample is unset else max_downsample,
                   u.tome_seed if seed is unset else seed)
        return self

    def set_freeu(self, scales=None) -> "StableDiffusion":
        """FreeU on the UNet with ``scales=(b1, b2, s1, s2)`` (e.g.
        ``dmtpu_torch.ops.freeu.SD15_DEFAULTS``), or off (None).  No parameter
        changes.  Returns self."""
        self.unet.set_freeu(scales)
        return self

    # --- the pieces --------------------------------------------------------
    def unet_forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                     context: torch.Tensor) -> torch.Tensor:
        return self.unet(x, timesteps, context=context)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z.float() / self.scale_factor)

    def encode_latent(self, x: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = DiagonalGaussianDistribution(self.vae.encode_moments(x)).sample(generator)
        return self.scale_factor * z

    def text_encoder_encode_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_encoder.encode_tokens(input_ids)

    def text_encoder_encode(self, text: List[str]) -> torch.Tensor:
        device = next(self.text_encoder.parameters()).device
        ids = torch.as_tensor(self.text_encoder.tokenize(text), device=device)
        return self.text_encoder_encode_tokens(ids)

    # --- the model_fn seam of the samplers ---------------------------------
    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                text_embed: torch.Tensor) -> torch.Tensor:
        return self.unet_forward(x, timesteps, text_embed)

    def make_model_fn(self) -> Callable[..., torch.Tensor]:
        """model_fn(x, t, text_embed=...) for the DDIM / DDPM samplers; each
        call a ``denoiser`` span while a profiler records."""

        def model_fn(x, t, text_embed=None, **kw):
            with profiling.span("denoiser", device=True):
                return self.unet_forward(x, t, text_embed)

        return model_fn
