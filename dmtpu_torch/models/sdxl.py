"""SDXL base: the GeneralConditioner, the SDXL UNet and the VAE.

Counterpart of ``dmtpu/models/sdxl.py``:

- ``concat_timestep_embedder_nd`` (reference: models/sdxl/conditioner.py:
  341-367): each scalar column embedded sinusoidally, the embeddings
  concatenated;
- ``SDXLConditioner`` (reference: models/sdxl/conditioner.py:62-179): CLIP-L
  at hidden layer 11, OpenCLIP bigG's penultimate hidden state (no final
  LayerNorm) and its projected pooled output, and three
  ``ConcatTimestepEmbedderND`` size / crop embeddings; ``crossattn`` is the
  two towers' hidden states concatenated on the feature axis, ``vector`` the
  pooled output and the three embeddings;
- ``StableDiffusionXL`` (reference: models/sdxl/stablediffusion.py:11-90).

Where the JAX classes are functional over a params dict ``{"unet", "vae",
"conditioner"}``, these are ``nn.Module``s that own their parts (state-dict
prefixes ``unet.``, ``vae.``, ``conditioner.clip_l.``,
``conditioner.clip_g.``), so their methods take no ``params``.  An sgm
checkpoint (``model.diffusion_model.``, ``first_stage_model.``,
``conditioner.embedders.{0,1}.``) loads through ``load_state_dict``
(``dmtpu_torch.convert.sd.split_sdxl_checkpoint``); the JAX package's params
through ``dmtpu_torch.convert.sdxl_state_dict_from_flax``.  Randomness comes
from explicit ``torch.Generator``s.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from dmtpu_torch.models.adm import timestep_embedding
from dmtpu_torch.models.stablediffusion import (
    AutoencoderKL,
    DiagonalGaussianDistribution,
    SDUNetModel,
    load_owned_,
    seeded_init_,
)
from dmtpu_torch.models.stablediffusion.text_encoders import (
    CLIP_TEXT_CONFIGS,
    CLIPTextTransformer,
)

_SGM_PREFIXES = ("model.diffusion_model.", "first_stage_model.", "conditioner.embedders.")
# the sd_xl_base GeneralConditioner, by the last part of each embedder's target
_BASE_EMBEDDERS = ["FrozenCLIPEmbedder", "FrozenOpenCLIPEmbedder2", "ConcatTimestepEmbedderND",
                   "ConcatTimestepEmbedderND", "ConcatTimestepEmbedderND"]


def concat_timestep_embedder_nd(x: Any, outdim: int) -> torch.Tensor:
    """[B] or [B, D] scalars -> [B, D * outdim]: each column embedded
    sinusoidally (``timestep_embedding``), the embeddings concatenated."""
    x = torch.as_tensor(x)
    if x.dim() == 1:
        x = x[:, None]
    b, dims = x.shape
    return timestep_embedding(x.reshape(-1), outdim).reshape(b, dims * outdim)


class SDXLConditioner(nn.Module):
    """The sd_xl_base conditioner: ``forward(tokens_l, tokens_g,
    original_size, crop_coords, target_size) -> (crossattn, vector)``, the
    sizes each [B, 2].

    ``emb_models`` (the GeneralConditioner list of the upstream yaml) is
    checked against the five-embedder base composition that this class
    builds, and its ``ConcatTimestepEmbedderND`` ``outdim`` is the
    ``embed_dim``; ``clip_l_overrides`` / ``clip_g_overrides`` shrink the
    towers for tests and demo configs.
    """

    def __init__(self, embed_dim: int = 256, emb_models: Any = None,
                 clip_l_overrides: Optional[Dict] = None,
                 clip_g_overrides: Optional[Dict] = None, device: Any = None, **_: Any):
        super().__init__()
        if emb_models is not None:
            suffixes = [cfg.get("target", "").rsplit(".", 1)[-1] for cfg in emb_models]
            if suffixes != _BASE_EMBEDDERS:
                raise ValueError(
                    "SDXLConditioner implements the sd_xl_base 5-embedder "
                    f"composition {_BASE_EMBEDDERS}; got emb_models={suffixes}. "
                    "Other compositions are not supported.")
            for cfg in emb_models:
                if cfg.get("target", "").endswith("ConcatTimestepEmbedderND"):
                    embed_dim = int((cfg.get("params") or {}).get("outdim", embed_dim))
        cfg_l = {**CLIP_TEXT_CONFIGS["clip-vit-l"], **(clip_l_overrides or {})}
        cfg_g = {**CLIP_TEXT_CONFIGS["open-clip-vit-bigg"], **(clip_g_overrides or {})}
        self.clip_l = CLIPTextTransformer(device=device, **cfg_l)
        self.clip_g = CLIPTextTransformer(device=device, **cfg_g)
        self.embed_dim = embed_dim

    def forward(self, tokens_l: torch.Tensor, tokens_g: torch.Tensor, original_size: Any,
                crop_coords: Any, target_size: Any,
                force_zero_text: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        z_l = self.clip_l(tokens_l, output_layer=-2)  # hidden_states[11]
        z_g, pooled = self.clip_g(tokens_g, output_layer="penultimate-nonorm",
                                  return_pooled=True)
        if force_zero_text:
            z_l, z_g, pooled = torch.zeros_like(z_l), torch.zeros_like(z_g), torch.zeros_like(pooled)
        crossattn = torch.cat([z_l, z_g], dim=-1)
        dev = pooled.device
        sizes = [concat_timestep_embedder_nd(torch.as_tensor(s, dtype=torch.float32, device=dev),
                                             self.embed_dim)
                 for s in (original_size, crop_coords, target_size)]
        return crossattn, torch.cat([pooled, *sizes], dim=-1)

    def get_unconditional_conditioning(self, tokens_l, tokens_g, empty_tokens_l, empty_tokens_g,
                                       original_size, crop_coords, target_size):
        """(c, uc): the prompt's conditioning and the empty prompt's with its
        text zeroed (``force_uc_zero_embeddings=['txt']``; reference:
        models/sdxl/conditioner.py:160-179)."""
        c = self(tokens_l, tokens_g, original_size, crop_coords, target_size)
        uc = self(empty_tokens_l, empty_tokens_g, original_size, crop_coords, target_size,
                  force_zero_text=True)
        return c, uc


class StableDiffusionXL(nn.Module):
    """The SDXL stack, instantiable from the reference's weight yaml
    (reference: models/sdxl/stablediffusion.py:11-90)."""

    def __init__(self, conditioner_config: Optional[Dict] = None,
                 vae_config: Optional[Dict] = None, unet_config: Optional[Dict] = None,
                 scale_factor: float = 0.13025,
                 low_vram_shift_enabled: bool = False,  # accepted for config parity
                 device: Any = None, **_: Any):
        super().__init__()
        from dmtpu_torch.utils.config import instantiate_from_config

        self.scale_factor = float(scale_factor)
        self.conditioner: SDXLConditioner = (
            instantiate_from_config(conditioner_config, device=device)
            if conditioner_config and "target" in conditioner_config
            else SDXLConditioner(device=device))
        self.vae: AutoencoderKL = (instantiate_from_config(vae_config, device=device)
                                   if vae_config else AutoencoderKL(device=device))
        self.unet: Optional[SDUNetModel] = (
            instantiate_from_config(unet_config, device=device) if unet_config else None)

    def init_params(self, generator: Optional[torch.Generator] = None,
                    img_size: int = 64) -> "StableDiffusionXL":
        """Seeded random parameters on the module's device, for demos and
        tests without a checkpoint (``seeded_init_``: the layers the modules
        zero-initialise stay zero).  ``img_size`` is accepted for parity."""
        seeded_init_(self, generator)
        return self

    def load_state_dict(self, state_dict: Mapping[str, Any],
                        clip_l_sd: Optional[Mapping[str, Any]] = None,
                        clip_g_sd: Optional[Mapping[str, Any]] = None,
                        strict: bool = True, **kwargs: Any):
        """Load an sgm SDXL checkpoint (the UNet under
        ``model.diffusion_model.``, the VAE under ``first_stage_model.``,
        CLIP-L under ``conditioner.embedders.0.transformer.`` and bigG under
        ``conditioner.embedders.1.model.``), where ``clip_l_sd`` /
        ``clip_g_sd`` may give the towers apart (HF or open_clip layout).  The
        towers take the leaves they own (open_clip's ``logit_scale`` is
        dropped, bigG's ``text_projection`` kept), as the JAX converter loads
        them non-strictly; a missing leaf still raises.  A dict in this
        module's own layout loads as with any ``nn.Module``."""
        if clip_l_sd is None and clip_g_sd is None and \
                not any(k.startswith(_SGM_PREFIXES) for k in state_dict):
            return super().load_state_dict(state_dict, strict=strict, **kwargs)
        from dmtpu_torch.convert.sd import split_sdxl_checkpoint

        parts = {name: None if part is None else {k: torch.as_tensor(v) for k, v in part.items()}
                 for name, part in split_sdxl_checkpoint(state_dict, clip_l_sd, clip_g_sd).items()}
        self.unet.load_state_dict(parts["unet"], strict=strict)
        self.vae.load_state_dict(parts["vae"], strict=strict)
        for name in ("clip_l", "clip_g"):
            if parts[name] is not None:
                load_owned_(getattr(self.conditioner, name), parts[name], strict)
        return self

    def load_weights(self, path: str) -> "StableDiffusionXL":
        """Load an sgm ``.safetensors`` / ``.ckpt`` (also with ``ema.shadow``
        or ``model`` at the top), a torch file in this module's layout, or the
        JAX package's ``.npz`` (``params``: ``{"unet", "vae",
        "conditioner"}``)."""
        from dmtpu_torch.scripts._common import load_npz_params, load_torch_weights

        if path.endswith(".npz"):
            from dmtpu_torch.convert.flax_bridge import sdxl_state_dict_from_flax

            return self.load_state_dict(sdxl_state_dict_from_flax(load_npz_params(path)))
        return self.load_state_dict(load_torch_weights(path))

    # --- the pieces --------------------------------------------------------
    def unet_forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
        return self.unet(x, timesteps, context=context, y=y)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z.float() / self.scale_factor)

    def encode_latent(self, x: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = DiagonalGaussianDistribution(self.vae.encode_moments(x)).sample(generator)
        return self.scale_factor * z

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
        return self.unet_forward(x, timesteps, context, y)

    def make_model_fn(self) -> Callable[..., torch.Tensor]:
        """model_fn(x, t, cond=(context, y)) for the samplers: the CFG
        ``cond_kwarg`` is the (context, y) pair under ``cond``."""

        def model_fn(x, t, cond=None, **kw):
            context, y = cond
            return self.unet_forward(x, t, context, y)

        return model_fn

