"""Stable Diffusion text to image: the logic of the JAX package's page
``streamlit/pages/3_Stable_Diffusion.py``, without widgets.

- ``load_sd``: the model of the SD weight config with the weights of a file
  (``StableDiffusion.load_weights``: a CompVis ``.ckpt`` / ``.safetensors``
  or the JAX ``merge_lora``'s ``.npz``) or, without one, seeded random
  weights (demo mode: the page warns); the CLIP tokenizer from a local
  directory.
- ``generate_sd``: the body of the Generate button: the prompt and the
  negative prompt through CLIP, a CFG sampler (``ddim ddpm dpmpp pfdiff``
  over the config's schedule; ``var_type`` only for ``ddpm``,
  ``cond_kwarg="text_embed"``) over the UNet, with ToMe at the full-resolution
  level and FreeU at SD1.5's scales when asked, then the VAE decode, for
  ``batch_count`` batches of ``batch_size``.  Offset noise adds a constant
  per sample (``offset_noise`` times a normal draw) to the initial noise.

It is ``scripts/sample_sd.py``'s pipeline pieces (``build_model``,
``encode_prompt``, ``serving_accelerators``) arranged as the page arranges
them; a ready model (``chip_smoke.py`` passes its own) serves as well as one
from ``load_sd``.  Each batch draws its noise (and the DDPM sampler's) from
a generator seeded by (seed, batch index): other draws than the page's
``fold_in``; ``noise`` hands the batches' initial latents in, offset
included (the tests give both packages the same).  The page's sampler cache
has no counterpart: the port compiles nothing.  Everything runs on the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple, Union

import torch

from dmtpu_torch.scripts.sample_mmdit import batch_seed
from dmtpu_torch.scripts.sample_sd import (
    _SAMPLERS,
    LATENT_CHANNELS,
    build_model,
    encode_prompt,
    resolve_device,
    serving_accelerators,
)
from dmtpu_torch.ui.uncond import as_config, batch_noise
from dmtpu_torch.utils.config import Config

SAMPLERS = ("ddim", "ddpm", "dpmpp", "pfdiff")
RESPACE_TYPES = ("uniform-linspace", "uniform-leading", "uniform-trailing")


def load_sd(config: Union[str, Mapping], weights: Optional[str] = None,
            tokenizer: Optional[str] = None, device: Any = None) -> Tuple[Config, Any]:
    """(config, model): the ``StableDiffusion`` of ``config`` (a YAML path or
    a mapping with ``model`` and ``diffusion``) on ``device`` (default the
    card), in eval mode, with the weights of ``weights`` or, without them,
    random ones from seed 0; ``tokenizer`` a local CLIPTokenizer directory."""
    dev = resolve_device("cuda" if device is None else str(device), cli="load_sd")
    conf = as_config(config)
    sd = build_model(conf, weights, dev)
    if tokenizer:
        from transformers import CLIPTokenizer

        sd.text_encoder.tokenizer = CLIPTokenizer.from_pretrained(tokenizer)
    return conf, sd


@torch.no_grad()
def generate_sd(conf: Mapping, sd: Any, prompt: str, negative: str = "", *,
                sampler: str = "ddim", steps: int = 50, scale: float = 7.5, height: int = 512,
                width: int = 512, offset_noise: float = 0.0, tome_ratio: float = 0.0,
                freeu: bool = False, batch_size: int = 1, batch_count: int = 1,
                respace_type: str = "uniform-linspace", seed: int = 0,
                real_weights: bool = False, device: Any = None,
                noise: Any = None) -> torch.Tensor:
    """One Generate: ``batch_count * batch_size`` images in [-1, 1], [N, 3,
    height, width] on the device.  ``real_weights`` says the model has loaded
    weights (a prompt then needs a tokenizer: demo pseudo-tokens are for
    random weights only).  ``noise`` ([N, 4, height / 8, width / 8], offset
    included) replaces the batches' initial latents."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler {sampler!r}: one of {list(SAMPLERS)}")
    dev = resolve_device("cuda" if device is None else str(device), cli="generate_sd")
    dp = dict(conf["diffusion"].get("params", None) or {})
    dp.pop("device", None)
    if sampler != "ddpm":
        dp.pop("var_type", None)  # the ancestral sampler's alone
    dp.update(respace_type=respace_type, respace_steps=steps, guidance_scale=scale,
              cond_kwarg="text_embed")
    diffuser = _SAMPLERS[sampler](**dp)
    shape = (LATENT_CHANNELS, height // 8, width // 8)
    out = []
    with serving_accelerators(sd, tome_ratio, 1, "sd15" if freeu else None):
        ce = encode_prompt(sd, prompt, batch_size, real_weights, dev)
        ue = encode_prompt(sd, negative, batch_size, real_weights, dev)
        model_fn = sd.make_model_fn()
        for i in range(batch_count):
            generator = torch.Generator(device=dev).manual_seed(batch_seed(seed, i))
            x = batch_noise(noise, i, batch_size, shape, generator, dev)
            if noise is None and offset_noise > 0:
                x = x + offset_noise * torch.randn(batch_size, 1, 1, 1, generator=generator,
                                                   device=dev)
            z = diffuser.sample(model_fn, x, generator, uncond_conditioning=ue,
                                model_kwargs={"text_embed": ce})
            out.append(sd.decode_latent(z).float().clamp(-1.0, 1.0))
    return torch.cat(out)
