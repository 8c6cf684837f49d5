"""Karras-style Euler ODE sampler.

Counterpart of ``dmtpu/diffusions/euler.py`` (reference:
diffusions/euler.py:7-66): a first-order step in sigma space, with the
per-step sigma values computed on the host in float64 into the tape.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dmtpu_torch.diffusions.ddpm import DDPM


class EulerSampler(DDPM):
    """Euler sampler for the DDPM-like diffusion process."""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        # sigma = sqrt((1 - ac) / ac), float64 on the host (reference: diffusions/euler.py:49)
        self.sigmas = np.sqrt((1.0 - self.alphas_cumprod) / self.alphas_cumprod)

    def sampler_tape(self) -> Dict[str, np.ndarray]:
        tape = super().sampler_tape()
        sig = self.sigmas[self.respaced_seq]
        sig_prev = np.concatenate([[0.0], sig[:-1]])  # sigma at t_prev (0 for t_prev = -1)
        tape["sigma"] = sig[::-1].astype(np.float32)
        tape["sigma_prev"] = sig_prev[::-1].astype(np.float32)
        tape["sqrt_1p_sigma2"] = np.sqrt(1.0 + sig ** 2)[::-1].astype(np.float32)
        tape["sqrt_1p_sigma_prev2"] = np.sqrt(1.0 + sig_prev ** 2)[::-1].astype(np.float32)
        return tape

    def denoise_step(self, model_output, xt, c, generator=None, objective=None):
        """x_t -> x_{t-1} by one Euler step in sigma space.
        (reference: diffusions/euler.py:50-66)"""
        p = self.predict(model_output, xt, c, objective=objective)
        pred_x0 = p["pred_x0"]
        bar_xt = c["sqrt_1p_sigma2"] * xt
        derivative = (bar_xt - pred_x0) / c["sigma"]
        sample = (bar_xt + derivative * (c["sigma_prev"] - c["sigma"])) / c["sqrt_1p_sigma_prev2"]
        return {
            "sample": sample,
            "mean": sample,
            "var": torch.zeros((), device=xt.device),
            "pred_x0": pred_x0,
            "pred_eps": p["pred_eps"],
            "reverse_eps": torch.zeros_like(xt),
        }
