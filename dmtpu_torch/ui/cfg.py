"""Class-conditional pixel-space sampling with classifier-free guidance: the
logic of the JAX package's page ``streamlit/pages/2_Class_Conditional_CFG.py``
and of the web UI's CFG branch (``webui/app.py``), without widgets.

- ``cfg_class``: the CFG sampler of each sampler name (``DDIMCFG``,
  ``DPMSolverPPCFG``, ``PFDiffDDIMCFG``, ``FlowMatchingCFG``,
  ``FlowDPMSolverCFG``, else ``DDPMCFG``), over the config's diffusion with
  the family gate of ``ui/uncond.py``;
- ``uncond_conditioning``: the null class ``num_classes`` (the label
  table's last row) as the unconditional branch;
- ``generate_cfg``: ``batch_count`` batches of ``n`` samples of one class,
  the conditional and unconditional halves as one model call on the doubled
  batch (``sample_cfg.pixel_model_fn``).

The model is loaded by ``uncond.load_pixel_model``.  Noise and the device
as in ``ui/uncond.py``: a generator seeded by (seed, batch index) per
batch, ``noise`` handed in for the tests, the card unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from dmtpu_torch.diffusions import (
    DDIMCFG,
    DDPMCFG,
    DPMSolverPPCFG,
    FlowDPMSolverCFG,
    FlowMatchingCFG,
    PFDiffDDIMCFG,
)
from dmtpu_torch.scripts._common import image_shape
from dmtpu_torch.scripts.sample_cfg import pixel_model_fn
from dmtpu_torch.scripts.sample_sd import resolve_device
from dmtpu_torch.scripts.sample_uncond import fold_generator
from dmtpu_torch.ui.uncond import batch_noise, sampler_params

CFG_SAMPLERS = {"ddim": DDIMCFG, "dpmpp": DPMSolverPPCFG, "pfdiff": PFDiffDDIMCFG,
                "flow": FlowMatchingCFG, "flowdpm": FlowDPMSolverCFG}
# the page offers these two, with these variances
PAGE_SAMPLERS = ("ddpm", "ddim")
PAGE_VAR_TYPES = ("fixed_small", "fixed_large")


def cfg_class(sampler: str) -> type:
    return CFG_SAMPLERS.get(sampler, DDPMCFG)


def uncond_conditioning(conf: Mapping, n: int, device: Any) -> torch.Tensor:
    """The unconditional branch's labels: the null class ``num_classes``."""
    return torch.full((n,), conf["data"]["num_classes"], dtype=torch.int64,
                      device=torch.device(device))


@torch.no_grad()
def generate_cfg(conf: Mapping, model: nn.Module, class_id: int, *, sampler: str = "ddim",
                 steps: int = 50, scale: float = 3.0, var_type: str = "fixed_small",
                 respace_type: str = "uniform", n: int = 16, batch_count: int = 1,
                 seed: int = 0, device: Any = None, noise: Any = None) -> torch.Tensor:
    """``batch_count * n`` samples of class ``class_id`` at guidance scale
    ``scale``, in [-1, 1], [N, C, H, W] on the device.  ``noise`` ([N, C, H,
    W]) replaces the batches' noise draws."""
    dev = resolve_device("cuda" if device is None else str(device), cli="generate_cfg")
    dp = sampler_params(conf, sampler, steps, var_type, respace_type)
    diffuser = cfg_class(sampler)(guidance_scale=scale, **dp)
    model_fn = pixel_model_fn(model, n)
    shape = image_shape(conf)
    y = torch.full((n,), int(class_id), dtype=torch.int64, device=dev)
    out = []
    for i in range(batch_count):
        generator = fold_generator(seed, i, dev)
        x = batch_noise(noise, i, n, shape, generator, dev)
        out.append(diffuser.sample(model_fn, x, generator,
                                   uncond_conditioning=uncond_conditioning(conf, n, dev),
                                   model_kwargs={"y": y}).float().clamp(-1.0, 1.0))
    return torch.cat(out)
