"""DPM-Solver++(2M): second-order multistep ODE sampler.

Counterpart of ``dmtpu/diffusions/dpm_solver.py`` (Lu et al.,
"DPM-Solver++: Fast Solver for Guided Sampling of Diffusion Probabilistic
Models", arXiv:2211.01095; the data-prediction multistep variant).  In the
VP / DDPM discrete setting:

    alpha_t = sqrt(abar_t),  sigma_t = sqrt(1 - abar_t),
    lambda_t = log(alpha_t / sigma_t),  h_i = lambda_{prev,i} - lambda_{cur,i}

    x_{prev} = (sigma_prev / sigma_cur) x  +  alpha_prev (1 - e^{-h}) D_i
    D_i      = (1 + 1/(2 r_i)) x0_i - (1/(2 r_i)) x0_{i-1},  r_i = h_{i-1}/h_i

Every per-step scalar (sigma ratios, e^{-h} terms, the multistep weights) is
computed on the host in float64 from the respaced sequence and appended to
the tape; ``sample_loop`` is a Python loop over the rows that carries
``(x, prev_x0)``.  The first step and the final step (t_prev = -1, h = inf)
use the first-order update (D = x0); rows with h = 0 (quad respacing repeats
timesteps) keep first order and do not feed r.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmtpu_torch.diffusions.ddpm import DDPM, DDPMCFG, ModelFn, Row


class DPMSolverPP(DDPM):
    """DPM-Solver++(2M) for the DDPM-like diffusion process (an ODE: it draws
    no noise)."""

    def sampler_tape(self) -> Dict[str, np.ndarray]:
        tape = super().sampler_tape()
        seq = self.respaced_seq.astype(np.int64)
        ac = self.alphas_cumprod[seq]              # float64, t ascending
        ac_prev = np.concatenate([[1.0], ac[:-1]])

        alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
        alpha_p, sigma_p = np.sqrt(ac_prev), np.sqrt(1.0 - ac_prev)
        with np.errstate(divide="ignore"):
            lam = np.log(alpha / sigma)
            lam_p = np.log(alpha_p / np.where(sigma_p == 0, np.nan, sigma_p))
        # rows in sampling order (t descending): row i steps seq[-1-i] -> prev
        h = (lam_p - lam)[::-1]                    # h[last] = inf (sigma_prev = 0)
        sigma_ratio = (np.where(sigma == 0, 0.0, sigma_p / sigma))[::-1]
        e_h = np.where(np.isfinite(h), np.exp(-np.where(np.isfinite(h), h, 0.0)), 0.0)
        alpha_e = alpha_p[::-1] * (1.0 - e_h)

        n = len(seq)
        c1 = np.ones(n)
        c2 = np.zeros(n)
        prev_h = None  # the last usable step width
        for i in range(n):
            if h[i] == 0.0 or not np.isfinite(h[i]):
                continue  # a no-op row, or the final step to t = -1: first order
            if prev_h is not None:
                r = prev_h / h[i]
                c1[i] = 1.0 + 1.0 / (2.0 * r)
                c2[i] = -1.0 / (2.0 * r)
            prev_h = h[i]

        tape["dpm_sigma_ratio"] = sigma_ratio.astype(np.float32)
        tape["dpm_alpha_e"] = alpha_e.astype(np.float32)
        tape["dpm_c1"] = c1.astype(np.float32)
        tape["dpm_c2"] = c2.astype(np.float32)
        return tape

    def _x0_step(self, model_fn: ModelFn, x: torch.Tensor, c: Row,
                 model_kwargs: Dict[str, Any]) -> torch.Tensor:
        """One model call -> pred_x0, the quantity the solver integrates."""
        t_batch = torch.full((x.shape[0],), c["t"], dtype=torch.int64, device=x.device)
        return self.predict(model_fn(x, t_batch, **model_kwargs), x, c)["pred_x0"]

    def sample_loop(
        self,
        model_fn: ModelFn,
        init_noise: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
        collect: Sequence[str] = (),
        start_step: int = 0,
        num_steps: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """As ``DDPM.sample_loop``; ``generator`` is accepted and unused.  A
        run that starts past row 0 (img2img) restarts the multistep weights
        at first order on its first row."""
        model_kwargs = model_kwargs or {}
        rows = self.tape_rows(self.sampler_tape())
        stop = len(rows) if num_steps is None else min(len(rows), start_step + num_steps)
        rows = rows[start_step:stop]
        if start_step != 0 and rows:
            rows[0] = dict(rows[0], dpm_c1=1.0, dpm_c2=0.0)
        x = init_noise.float()
        prev_x0 = torch.zeros_like(x)
        ys: Dict[str, list] = {k: [] for k in collect}
        for c in rows:
            x0 = self._x0_step(model_fn, x, c, model_kwargs)
            d = c["dpm_c1"] * x0 + c["dpm_c2"] * prev_x0
            x_next = c["dpm_sigma_ratio"] * x + c["dpm_alpha_e"] * d
            if collect:
                zeros = torch.zeros_like(x_next)
                outs = {"sample": x_next, "mean": x_next, "pred_x0": x0, "pred_eps": zeros,
                        "reverse_eps": zeros, "var": torch.zeros((), device=x.device)}
                for k in collect:
                    ys[k].append(outs[k])
            x, prev_x0 = x_next, x0
        return x, {k: torch.stack(v) for k, v in ys.items()}

    def sample(self, model_fn: ModelFn, init_noise: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any) -> torch.Tensor:
        final, _ = self.sample_loop(model_fn, init_noise, generator, model_kwargs, **kwargs)
        return final


class DPMSolverPPCFG(DPMSolverPP, DDPMCFG):
    """DPM-Solver++(2M) with classifier-free guidance: the one doubled-batch
    model call of ``DDPMCFG``, guidance combined on eps, converted to the x0
    the solver integrates."""

    def __init__(self, *args: Any, **kwargs: Any):
        if kwargs.get("guidance_interval") is not None:
            # the interval gate lives in DDPMCFG._model_step, which this
            # solver does not call: refuse rather than ignore it
            raise NotImplementedError(
                "guidance_interval is supported by DDPMCFG/DDIMCFG only; the "
                "multi-step solver history here needs interval-aware rework")
        super().__init__(*args, **kwargs)

    def _x0_step(self, model_fn, x, c, model_kwargs):
        pred_eps, _ = self._cfg_model_output(model_fn, x, c, model_kwargs)
        return self.predict(pred_eps, x, c, objective="pred_eps")["pred_x0"]

    def sample_loop(self, model_fn: ModelFn, init_noise: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    uncond_conditioning: Any = None,
                    model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any):
        mk = dict(model_kwargs or {})
        mk[self._UNCOND_KEY] = uncond_conditioning
        return DPMSolverPP.sample_loop(self, model_fn, init_noise, generator, mk, **kwargs)

    def sample(self, model_fn: ModelFn, init_noise: torch.Tensor,
               generator: Optional[torch.Generator] = None, uncond_conditioning: Any = None,
               model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any) -> torch.Tensor:
        final, _ = self.sample_loop(model_fn, init_noise, generator, uncond_conditioning,
                                    model_kwargs, **kwargs)
        return final
