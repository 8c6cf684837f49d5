"""Stable Diffusion XL text to image: the logic of the JAX package's page
``streamlit/pages/4_Stable_Diffusion_XL.py``, without widgets.

- ``load_sdxl`` is the page's ``load_sdxl`` (:34-46): the model from the
  SDXL weight config, with the weights of a file (``load_weights``: an sgm
  ``.safetensors`` / ``.ckpt``, a torch file in the port's layout or the
  JAX package's ``.npz``) or, without one, seeded random weights.
- ``generate_sdxl`` is the body of the Generate button (:69-117): the
  conditioner's cond / uncond pairs (the size and crop embeddings of the
  requested height and width; an empty negative prompt is the zeroed text
  of ``force_zero_text``), a CFG sampler (DDIM, DPM-Solver++ or DDPM over
  the config's schedule, ``cond_kwarg="cond"``) over the UNet with the
  ``(context, y)`` pair, and the VAE decode, for ``batch_count`` batches of
  ``batch_size``.

Tokenisation is the caller's: prompts are token-id pairs ``(ids_l, ids_g)``
for the CLIP-L and bigG towers, or strings with ``tokenizers=(tok_l,
tok_g)`` (``transformers`` CLIPTokenizers from local paths).  Each batch
draws its noise (and the DDPM sampler's) from a ``torch.Generator`` seeded
by (seed, batch index): other draws than the page's ``fold_in``.  The
page's sampler cache has no counterpart: the port compiles nothing.
Everything runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dmtpu_torch.diffusions import DDIMCFG, DDPMCFG, DPMSolverPPCFG
from dmtpu_torch.models.sdxl import StableDiffusionXL
from dmtpu_torch.scripts.sample_mmdit import batch_seed
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.utils.config import Config, instantiate_from_config, load_config

SAMPLERS = {"DDIM": DDIMCFG, "DPM-Solver++": DPMSolverPPCFG, "DDPM": DDPMCFG}
MAX_LENGTH = 77

Prompt = Union[str, Sequence[Any], None]


def load_sdxl(config: Union[str, Mapping], weights: Optional[str] = None,
              device: Any = None, generator: Optional[torch.Generator] = None
              ) -> Tuple[Config, StableDiffusionXL]:
    """(config, model): the model of ``config`` (a YAML path or a mapping
    with ``model`` and ``diffusion``) on ``device`` (default the card), in
    eval mode, with the weights of ``weights`` or seeded random ones (from
    ``generator``, else a generator on the device seeded with 0)."""
    device = resolve_device("cuda" if device is None else str(device), cli="load_sdxl")
    conf = load_config(config) if isinstance(config, str) else Config(config)
    model = instantiate_from_config(conf.model, device=device).eval()
    if weights:
        model.load_weights(weights)
    else:
        model.init_params(generator if generator is not None
                          else torch.Generator(device=device).manual_seed(0))
    return conf, model


def _token_ids(prompt: Prompt, tokenizers: Optional[Sequence[Any]], n: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A prompt's (ids_l, ids_g), each [n, 77] on ``device``."""
    if isinstance(prompt, str):
        if tokenizers is None:
            raise ValueError("a text prompt needs tokenizers=(tok_l, tok_g); or pass token ids")
        pair = [tok([prompt], truncation=True, max_length=MAX_LENGTH, padding="max_length",
                    return_tensors="np")["input_ids"] for tok in tokenizers]
    else:
        pair = list(prompt)
    out = []
    for ids in pair:
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=device)
        ids = ids.reshape(-1, ids.shape[-1])
        out.append(ids.expand(n, -1) if ids.shape[0] == 1 else ids)
    return out[0], out[1]


def _noise(batch: int, shape: Sequence[int], generator: torch.Generator,
           device: torch.device) -> torch.Tensor:
    return torch.randn(batch, *shape, generator=generator, device=device)


@torch.no_grad()
def generate_sdxl(conf: Mapping, model: StableDiffusionXL, prompt: Prompt, negative: Prompt = "",
                  *, tokenizers: Optional[Sequence[Any]] = None, sampler: str = "DDIM",
                  steps: int = 50, scale: float = 5.0, height: int = 1024, width: int = 1024,
                  offset_noise: float = 0.0, batch_size: int = 1, batch_count: int = 1,
                  respace_type: str = "uniform-linspace", seed: int = 0, device: Any = None
                  ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """One Generate: ``batch_count * batch_size`` images in [-1, 1], [N, 3,
    height, width] on the device, and on a card the stages' times in ms by
    CUDA events (``{"conditioner", "sample", "decode"}``, summed over the
    batches; empty on the CPU).  ``negative`` "" or None is the zeroed
    text."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler {sampler!r}: one of {sorted(SAMPLERS)}")
    dev = resolve_device("cuda" if device is None else str(device), cli="generate_sdxl")
    dp = dict(conf["diffusion"].get("params", {}))
    dp.pop("device", None)
    dp.update(respace_type=respace_type, respace_steps=steps, guidance_scale=scale,
              cond_kwarg="cond")
    diffuser = SAMPLERS[sampler](**dp)
    events = []

    def mark(name: str) -> None:
        if dev.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append((name, event))

    mark("begin")
    size = torch.tensor([[height, width]], dtype=torch.float32, device=dev).repeat(batch_size, 1)
    sizes = dict(original_size=size, crop_coords=torch.zeros_like(size), target_size=size)
    ids = _token_ids(prompt, tokenizers, batch_size, dev)
    empty = negative is None or (isinstance(negative, str) and not negative)
    # an empty negative's text is zeroed (force_zero_text): its ids do not matter
    neg_ids = ids if empty else _token_ids(negative, tokenizers, batch_size, dev)
    cond = model.conditioner(*ids, **sizes)
    uncond = model.conditioner(*neg_ids, force_zero_text=empty, **sizes)
    mark("conditioner")
    shape = (model.unet.in_channels, height // 8, width // 8)
    model_fn = model.make_model_fn()
    out = []
    for i in range(batch_count):
        generator = torch.Generator(device=dev).manual_seed(batch_seed(seed, i))
        noise = _noise(batch_size, shape, generator, dev)
        if offset_noise > 0:
            noise = noise + offset_noise * _noise(batch_size, (1, 1, 1), generator, dev)
        z = diffuser.sample(model_fn, noise, generator, uncond_conditioning=uncond,
                            model_kwargs={"cond": cond})
        mark("sample")
        out.append(model.decode_latent(z).float().clamp(-1.0, 1.0))
        mark("decode")
    stage_ms: Dict[str, float] = {}
    if events:
        events[-1][1].synchronize()
        for (_, before), (name, after) in zip(events, events[1:]):
            stage_ms[name] = stage_ms.get(name, 0.0) + before.elapsed_time(after)
    return torch.cat(out), stage_ms
