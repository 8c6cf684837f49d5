"""The diffusion arithmetic the cells use, in plain NumPy and PyTorch.

- ``alphas_cumprod``: the linear and the scaled-linear ("quad") beta
  schedules (Ho et al. 2020; CompVis's SD schedule), cumulative products
  in float64.
- ``ddim_cfg``: DDIM with eta 0 (Song et al. 2021) over uniformly respaced
  steps, with classifier-free guidance (Ho & Salimans 2022): one model call
  a step on the batch [x, x] with the conditional and the unconditional
  inputs, eps = eps_u + s (eps_c - eps_u), the predicted x0 clipped to
  [-1, 1] and eps recomputed from it.
- ``eps_mse``: the training loss, the mean squared error of the model's eps.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def alphas_cumprod(schedule: str, start: float, end: float, steps: int = 1000) -> np.ndarray:
    if schedule == "linear":
        betas = np.linspace(start, end, steps, dtype=np.float64)
    elif schedule == "quad":
        betas = np.linspace(start ** 0.5, end ** 0.5, steps, dtype=np.float64) ** 2
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return np.cumprod(1.0 - betas)


def schedule_of(params) -> np.ndarray:
    """``alphas_cumprod`` of a config's ``diffusion.params``."""
    return alphas_cumprod(params["beta_schedule"], params["beta_start"], params["beta_end"],
                          params["total_steps"])


def uniform_steps(total: int, steps: int) -> np.ndarray:
    return np.arange(0, total, total // steps, dtype=np.int64)


def ddim_cfg(model: Callable[[torch.Tensor, torch.Tensor, object], torch.Tensor],
             noise: torch.Tensor, cond, uncond, ac: np.ndarray, steps: int,
             guidance: float, cat: Callable = lambda a, b: torch.cat([a, b])) -> torch.Tensor:
    """DDIM-CFG from ``noise``; ``model(x, t, c)`` with ``c = cat(cond, uncond)``."""
    seq = uniform_steps(len(ac), steps)
    f32 = lambda v: float(np.float32(v))  # the step's scalars, rounded once
    x = noise.float()
    c2 = cat(cond, uncond)
    for i in reversed(range(len(seq))):
        a, a_prev = ac[seq[i]], (ac[seq[i - 1]] if i > 0 else 1.0)
        recip, recipm1 = f32(np.sqrt(1.0 / a)), f32(np.sqrt(1.0 / a - 1.0))
        t = torch.full((2 * x.shape[0],), int(seq[i]), dtype=torch.int64, device=x.device)
        out_c, out_u = model(torch.cat([x, x]), t, c2).float().chunk(2)

        def eps_of(out):
            x0 = (recip * x - recipm1 * out).clamp(-1.0, 1.0)
            return (recip * x - x0) / recipm1

        eps = (1.0 - guidance) * eps_of(out_u) + guidance * eps_of(out_c)
        x0 = (recip * x - recipm1 * eps).clamp(-1.0, 1.0)
        eps = (recip * x - x0) / recipm1
        x = f32(np.sqrt(a_prev)) * x0 + f32(np.sqrt(max(1.0 - a_prev, 0.0))) * eps
    return x


def eps_mse(pred: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - eps.float()))


def diffuse(x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor, ac: np.ndarray) -> torch.Tensor:
    a = torch.from_numpy(ac.astype(np.float32)).to(x0.device)[t.long()]
    a = a.reshape((-1,) + (1,) * (x0.dim() - 1))
    return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps


def to_uint8(images: torch.Tensor) -> np.ndarray:
    """[N, 3, H, W] in [-1, 1] -> [N, H, W, 3] uint8, as the image files hold
    them: (x + 1) / 2 clipped to [0, 1], times 255, truncated."""
    x = (images.float().permute(0, 2, 3, 1).cpu().numpy() + 1.0) / 2.0
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)
