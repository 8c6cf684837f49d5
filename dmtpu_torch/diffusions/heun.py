"""Karras-style second-order Heun sampler.

Counterpart of ``dmtpu/diffusions/heun.py`` (reference:
diffusions/heun.py:56-131): each step of the loop is the Euler predictor
and the trapezoid corrector for one (t, t_prev) pair, two model calls; the
last pair (t_prev = -1) is a single predictor step, so a run makes the
reference's 2N - 1 calls.  The corrector's coefficients at t_prev are
computed on the host in float64 into the tape.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmtpu_torch.diffusions.ddpm import ModelFn, Row
from dmtpu_torch.diffusions.euler import EulerSampler


class HeunSampler(EulerSampler):
    """Heun sampler for the DDPM-like diffusion process."""

    def sampler_tape(self) -> Dict[str, np.ndarray]:
        tape = super().sampler_tape()
        seq = self.respaced_seq
        ac_prev = np.concatenate([[1.0], self.alphas_cumprod[seq][:-1]])
        # predict()'s coefficients at t_prev, for the corrector
        tape["t_prev"] = np.concatenate([[-1], seq[:-1]])[::-1].astype(np.int32)
        tape["prev_sqrt_ac"] = np.sqrt(ac_prev)[::-1].astype(np.float32)
        tape["prev_sqrt_1m_ac"] = np.sqrt(1.0 - ac_prev)[::-1].astype(np.float32)
        tape["prev_sqrt_recip_ac"] = np.sqrt(1.0 / ac_prev)[::-1].astype(np.float32)
        tape["prev_sqrt_recipm1_ac"] = np.sqrt(
            np.maximum(1.0 / ac_prev - 1.0, 0.0))[::-1].astype(np.float32)
        return tape

    def _heun_step(self, model_fn: ModelFn, xt: torch.Tensor, c: Row,
                   model_kwargs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Predictor and corrector for one (t, t_prev) pair, t_prev >= 0."""
        b = xt.shape[0]
        # Euler predictor (reference: diffusions/heun.py:56-76)
        t_batch = torch.full((b,), c["t"], dtype=torch.int64, device=xt.device)
        p1 = self.predict(model_fn(xt, t_batch, **model_kwargs), xt, c)
        bar_xt = c["sqrt_1p_sigma2"] * xt
        d1 = (bar_xt - p1["pred_x0"]) / c["sigma"]
        x_mid = (bar_xt + d1 * (c["sigma_prev"] - c["sigma"])) / c["sqrt_1p_sigma_prev2"]
        # trapezoid corrector (reference: diffusions/heun.py:78-102)
        c_prev = {"sqrt_recip_ac": c["prev_sqrt_recip_ac"],
                  "sqrt_recipm1_ac": c["prev_sqrt_recipm1_ac"],
                  "sqrt_ac": c["prev_sqrt_ac"], "sqrt_1m_ac": c["prev_sqrt_1m_ac"]}
        tp_batch = torch.full((b,), c["t_prev"], dtype=torch.int64, device=xt.device)
        p2 = self.predict(model_fn(x_mid, tp_batch, **model_kwargs), x_mid, c_prev)
        d2 = (c["sqrt_1p_sigma_prev2"] * x_mid - p2["pred_x0"]) / c["sigma_prev"]
        sample = (bar_xt + (d1 + d2) / 2.0 * (c["sigma_prev"] - c["sigma"])) \
            / c["sqrt_1p_sigma_prev2"]
        # every key the other samplers' ``collect`` takes
        return {
            "sample": sample,
            "mean": sample,
            "var": torch.zeros((), device=xt.device),
            "pred_x0": p2["pred_x0"],
            "pred_eps": p2["pred_eps"],
            "reverse_eps": torch.zeros_like(sample),
        }

    def sample_loop(self, model_fn: ModelFn, init_noise: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    model_kwargs: Optional[Dict[str, Any]] = None, collect: Sequence[str] = (),
                    start_step: int = 0, num_steps: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(reference: diffusions/heun.py:104-131); ``generator`` is accepted
        and unused (an ODE sampler)."""
        model_kwargs = model_kwargs or {}
        rows = self.tape_rows(self.sampler_tape())
        stop = len(rows) if num_steps is None else min(len(rows), start_step + num_steps)
        rows = rows[start_step:stop]
        # every row but the last has t_prev >= 0: predictor and corrector
        has_final = stop == len(self.respaced_seq)
        x = init_noise.float()
        ys: Dict[str, list] = {k: [] for k in collect}
        for i, c in enumerate(rows):
            if has_final and i == len(rows) - 1:
                # the last pair (t = seq[0], t_prev = -1): one predictor step
                t_batch = torch.full((x.shape[0],), c["t"], dtype=torch.int64, device=x.device)
                out = EulerSampler.denoise_step(self, model_fn(x, t_batch, **model_kwargs), x, c)
            else:
                out = self._heun_step(model_fn, x, c, model_kwargs)
            for k in collect:
                ys[k].append(out[k])
            x = out["sample"]
        return x, {k: torch.stack(v) for k, v in ys.items()}
