"""Unconditional pixel-space sampling: the logic of the JAX package's page
``streamlit/pages/1_Unconditional_Image_Generation.py`` and of the web UI's
unconditional branch (``webui/app.py``), without widgets.

- The sampler family gate: a flow config (its diffusion target names
  ``flow``) offers ``flow`` and ``flowdpm``, any other ``ddpm ddim euler
  heun dpmpp pfdiff``; a flow-trained and an eps-trained checkpoint are not
  sampler-interchangeable, so the other family is refused
  (``check_sampler``).  ``flowdpm`` sets ``solver: dpm`` over a flow
  config's euler / heun.  Each family has its respace types.
- ``load_pixel_model``: the config's model on the device, in eval mode,
  with the weights of a file (``scripts/_common.py::load_model_params``: a
  torch file or the JAX package's ``.npz`` export).
- ``generate_uncond``: ``batch_count`` batches of ``n`` samples.  On a
  class-conditional model (``UNetCategorialAdaGN``) unconditional sampling
  is the null-class row ``num_classes``, not class 0.

Each batch draws its noise, then its sampler's steps, from a generator on
the device seeded by (seed, batch index) (``sample_uncond.fold_generator``):
other draws than the page's ``fold_in``; ``noise`` hands the batches' noise
in (the tests give both packages the same).  The page's cache of compiled
samplers has no counterpart: the port compiles nothing.  Everything runs on
the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple, Union

import torch
from torch import nn

from dmtpu_torch.scripts._common import image_shape, load_model_params
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.scripts.sample_uncond import SAMPLERS, fold_generator, model_function
from dmtpu_torch.utils.config import Config, instantiate_from_config, load_config

EPS_SAMPLERS = ("ddpm", "ddim", "euler", "heun", "dpmpp", "pfdiff")
FLOW_SAMPLERS = ("flow", "flowdpm")
# the flow family names its step grids otherwise ("uniform-linspace" is the
# eps family's only)
EPS_RESPACE_TYPES = ("uniform-linspace", "uniform-leading", "uniform-trailing")
FLOW_RESPACE_TYPES = ("uniform", "uniform-leading", "uniform-trailing", "quad")
VAR_TYPES = ("fixed_small", "fixed_large", "learned_range")


def as_config(config: Union[str, Mapping]) -> Config:
    """A YAML path or a mapping as a ``Config``."""
    return load_config(config) if isinstance(config, str) else Config(config)


def is_flow(conf: Mapping) -> bool:
    return "flow" in str(conf["diffusion"].get("target", "")).lower()


def is_conditional(conf: Mapping) -> bool:
    """A class-conditional pixel model ``(x, t, y)``, as the web UI tells it."""
    target = str(conf["model"]["target"]).lower()
    return "adagn" in target or "categorial" in target


def sampler_names(conf: Mapping) -> Tuple[str, ...]:
    return FLOW_SAMPLERS if is_flow(conf) else EPS_SAMPLERS


def default_sampler(conf: Mapping) -> str:
    """A bare request's sampler: deterministic DDIM for an eps config."""
    return "flow" if is_flow(conf) else "ddim"


def respace_types(conf: Mapping) -> Tuple[str, ...]:
    return FLOW_RESPACE_TYPES if is_flow(conf) else EPS_RESPACE_TYPES


def check_sampler(conf: Mapping, sampler: str) -> None:
    """Refuse a sampler of the other family, with the web UI's message."""
    if sampler not in sampler_names(conf):
        raise ValueError(
            f"sampler {sampler!r} does not match this checkpoint's diffusion family (config "
            f"target {conf['diffusion'].get('target')}); available: "
            f"{', '.join(sampler_names(conf))}")


def sampler_params(conf: Mapping, sampler: str, steps: int, var_type: str,
                   respace_type: str) -> Dict[str, Any]:
    """The sampler's constructor arguments over the config's diffusion."""
    check_sampler(conf, sampler)
    dp = dict(conf["diffusion"].get("params", None) or {})
    dp.pop("device", None)
    dp.update(respace_type=respace_type, respace_steps=steps, var_type=var_type)
    if sampler == "flowdpm":
        dp["solver"] = "dpm"  # FlowDPMSolver is the solver: over a flow config's euler / heun
    return dp


def load_pixel_model(config: Union[str, Mapping], weights: str, device: Any = None
                     ) -> Tuple[Config, nn.Module]:
    """(config, model): the model of ``config`` on ``device`` (default the
    card), in eval mode, with the weights of ``weights``."""
    dev = resolve_device("cuda" if device is None else str(device), cli="load_pixel_model")
    conf = as_config(config)
    model = instantiate_from_config(conf["model"], device=dev)
    return conf, load_model_params(weights, model).eval()


def uncond_model_function(conf: Mapping, model: nn.Module) -> Callable[..., torch.Tensor]:
    """The samplers' ``model_fn(x, t)``: a conditional model gets the null
    class ``num_classes`` for every row."""
    if not is_conditional(conf):
        return model_function(model)
    null = conf["data"]["num_classes"]
    return lambda x, t, **kw: model(x, t, torch.full((x.shape[0],), null, dtype=torch.int64,
                                                     device=x.device))


def batch_noise(noise: Any, i: int, n: int, shape, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """Batch ``i``'s noise: rows ``[i * n, (i + 1) * n)`` of the given
    ``noise``, else drawn from ``generator``."""
    if noise is None:
        return torch.randn(n, *shape, generator=generator, device=device)
    return torch.as_tensor(noise, dtype=torch.float32)[i * n:(i + 1) * n].to(device)


@torch.no_grad()
def generate_uncond(conf: Mapping, model: nn.Module, *, sampler: str = "ddim", steps: int = 50,
                    var_type: str = "fixed_small", respace_type: str = "uniform", n: int = 16,
                    batch_count: int = 1, seed: int = 0, device: Any = None,
                    noise: Any = None) -> torch.Tensor:
    """``batch_count * n`` samples in [-1, 1], [N, C, H, W] on the device.
    ``noise`` ([N, C, H, W]) replaces the batches' noise draws."""
    dev = resolve_device("cuda" if device is None else str(device), cli="generate_uncond")
    diffuser = SAMPLERS[sampler](**sampler_params(conf, sampler, steps, var_type, respace_type))
    model_fn = uncond_model_function(conf, model)
    shape = image_shape(conf)
    out = []
    for i in range(batch_count):
        generator = fold_generator(seed, i, dev)
        x = batch_noise(noise, i, n, shape, generator, dev)
        out.append(diffuser.sample(model_fn, x, generator).float().clamp(-1.0, 1.0))
    return torch.cat(out)
