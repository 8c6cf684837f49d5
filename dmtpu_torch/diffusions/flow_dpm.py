"""FlowDPM: DPM-Solver++(2M) for the rectified-flow family.

Counterpart of ``dmtpu/diffusions/flow_dpm.py``.  The interpolant
``x_u = (1 - u) x0 + u eps`` has ``alpha_u = 1 - u``, ``sigma_u = u`` and
half-log-SNR ``lambda_u = log((1 - u) / u)``; DPM-Solver++'s data-prediction
update carries over:

    x_next = (sigma_next / sigma) x + alpha_next (1 - e^{-h}) D
    h      = lambda_next - lambda
    D      = (1 + 1/(2r)) x0_i - (1/(2r)) x0_{i-1},   r = h_{i-1} / h_i

with ``x0 = x - u v`` from the model's velocity.  Every per-step scalar is
computed on the host in float64, the infinities of the endpoints (h = inf
at u = 1 and at u_next = 0: first-order steps) resolved before the float32
tape; ``sample_loop`` is a Python loop over its rows that carries
``(x, prev_x0)``.  One model call a step; CFG takes ``FlowMatchingCFG``'s
one call on the doubled batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmtpu_torch.diffusions.flow import FlowMatching, FlowMatchingCFG, ModelFn, Row


class FlowDPMSolver(FlowMatching):
    """DPM-Solver++(2M) over the rectified-flow ODE (deterministic).

    Takes ``FlowMatching``'s arguments but ``solver`` (the multistep update is
    the solver; ``sample_inversion`` falls back to first-order Euler).
    """

    def __init__(self, *args: Any, **kwargs: Any):
        if kwargs.pop("solver", None) not in (None, "dpm"):
            raise ValueError("FlowDPMSolver is itself the solver; do not pass solver= "
                             "(or pass 'dpm')")
        super().__init__(*args, solver="euler", **kwargs)

    def sampler_tape(self) -> Dict[str, np.ndarray]:
        tape = super().sampler_tape()
        u = tape["u"].astype(np.float64)
        u_next = tape["u_next"].astype(np.float64)
        with np.errstate(divide="ignore"):
            lam = np.log((1.0 - u) / u)            # -inf at u = 1
            lam_n = np.log((1.0 - u_next) / np.where(u_next == 0, np.nan, u_next))
        lam_n = np.where(u_next == 0, np.inf, lam_n)
        h = lam_n - lam                            # inf on the first and last rows
        e_h = np.where(np.isfinite(h), np.exp(-np.where(np.isfinite(h), h, 0.0)), 0.0)

        n = len(u)
        c1, c2 = np.ones(n), np.zeros(n)
        prev_h = None  # rows of infinite h stay first order and do not feed r
        for i in range(n):
            if h[i] == 0.0 or not np.isfinite(h[i]):
                continue
            if prev_h is not None:
                r = prev_h / h[i]
                c1[i] = 1.0 + 1.0 / (2.0 * r)
                c2[i] = -1.0 / (2.0 * r)
            prev_h = h[i]

        tape["dpm_sigma_ratio"] = (u_next / u).astype(np.float32)  # u > 0 on every row
        tape["dpm_alpha_e"] = ((1.0 - u_next) * (1.0 - e_h)).astype(np.float32)
        tape["dpm_c1"] = c1.astype(np.float32)
        tape["dpm_c2"] = c2.astype(np.float32)
        return tape

    def _x0_step(self, model_fn: ModelFn, x: torch.Tensor, c: Row,
                 model_kwargs: Dict[str, Any]) -> torch.Tensor:
        """One (CFG: doubled-batch) velocity call -> pred_x0."""
        return x - c["u"] * self._velocity(model_fn, x, c["u"], model_kwargs)

    def sample_loop(self, model_fn: ModelFn, init_noise: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    model_kwargs: Optional[Dict[str, Any]] = None, collect: Sequence[str] = (),
                    start_step: int = 0, num_steps: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """As ``FlowMatching.sample_loop``.  A run that starts past row 0
        restarts the multistep weights at first order on its first row."""
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
            x_next = c["dpm_sigma_ratio"] * x + c["dpm_alpha_e"] * (
                c["dpm_c1"] * x0 + c["dpm_c2"] * prev_x0)
            if collect:
                # u > 0 on every row, so the (guided) velocity is recoverable
                outs = {"sample": x_next, "pred_x0": x0, "velocity": (x - x0) / c["u"]}
                for k in collect:
                    ys[k].append(outs[k])
            x, prev_x0 = x_next, x0
        return x, {k: torch.stack(v) for k, v in ys.items()}


class FlowDPMSolverCFG(FlowMatchingCFG, FlowDPMSolver):
    """FlowDPM with classifier-free guidance: ``FlowMatchingCFG``'s guided
    velocity and ``uncond_conditioning`` threading, ``FlowDPMSolver``'s
    multistep tape and loop."""
