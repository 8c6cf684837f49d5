"""Explicit guidance: pluggable per-step hooks inside the sampling loop.

Counterpart of ``dmtpu/diffusions/guidance/base.py``.  The reference hooks
guidance at four points (predicted eps, predicted x0, posterior mean, sampled
x_{t-1}) and re-propagates each hook's delta to the other quantities
(reference: diffusions/guidance/base.py:46-142).  Each hook is a function of
(step outputs, xt, tape row, generator) that returns a delta tensor, or None
to leave its quantity alone.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from dmtpu_torch.diffusions.ddpm import DDPM, Row

Out = Dict[str, torch.Tensor]


class BaseGuidance(DDPM):
    """DDPM whose loop applies the four-point guidance transform."""

    # --- conversions on one tape row -----------------------------------------
    @staticmethod
    def pred_mu_from_x0(xt: torch.Tensor, c: Row, x0: torch.Tensor) -> torch.Tensor:
        """(reference: diffusions/guidance/base.py:28-36)"""
        return c["mean_coef1"] * x0 + c["mean_coef2"] * xt

    @staticmethod
    def pred_x0_from_mu(xt: torch.Tensor, c: Row, mu: torch.Tensor) -> torch.Tensor:
        """(reference: diffusions/guidance/base.py:38-44)"""
        return (mu - c["mean_coef2"] * xt) / c["mean_coef1"]

    @staticmethod
    def _pred_x0_from_eps_c(xt: torch.Tensor, c: Row, eps: torch.Tensor) -> torch.Tensor:
        return c["sqrt_recip_ac"] * xt - c["sqrt_recipm1_ac"] * eps

    @staticmethod
    def _pred_eps_from_x0_c(xt: torch.Tensor, c: Row, x0: torch.Tensor) -> torch.Tensor:
        return (c["sqrt_recip_ac"] * xt - x0) / c["sqrt_recipm1_ac"]

    # --- hook points (return a delta tensor, or None to skip) ----------------
    def cond_fn_eps(self, out: Out, xt: torch.Tensor, c: Row,
                    generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        return None

    def cond_fn_x0(self, out: Out, xt: torch.Tensor, c: Row,
                   generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        return None

    def cond_fn_mean(self, out: Out, xt: torch.Tensor, c: Row,
                     generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        return None

    def cond_fn_sample(self, out: Out, xt: torch.Tensor, c: Row,
                       generator: Optional[torch.Generator]) -> Optional[torch.Tensor]:
        return None

    # ------------------------------------------------------------------
    def apply_guidance(self, out: Out, xt: torch.Tensor, c: Row,
                       generator: Optional[torch.Generator] = None) -> Out:
        """(reference: diffusions/guidance/base.py:74-142)"""
        new = dict(out)
        var, reverse_eps, nz = out["var"], out["reverse_eps"], c["nonzero"]
        std = var ** 0.5

        g = self.cond_fn_eps(out, xt, c, generator)
        if g is not None:
            new["pred_eps"] = out["pred_eps"] + g
            new["pred_x0"] = self._pred_x0_from_eps_c(xt, c, new["pred_eps"])
            new["mean"] = self.pred_mu_from_x0(xt, c, new["pred_x0"])
            new["sample"] = new["mean"] + nz * std * reverse_eps

        g = self.cond_fn_x0(out, xt, c, generator)
        if g is not None:
            new["pred_x0"] = out["pred_x0"] + g
            new["pred_eps"] = self._pred_eps_from_x0_c(xt, c, new["pred_x0"])
            new["mean"] = self.pred_mu_from_x0(xt, c, new["pred_x0"])
            new["sample"] = new["mean"] + nz * std * reverse_eps

        g = self.cond_fn_mean(out, xt, c, generator)
        if g is not None:
            new["mean"] = out["mean"] + g
            new["pred_x0"] = self.pred_x0_from_mu(xt, c, new["mean"])
            new["pred_eps"] = self._pred_eps_from_x0_c(xt, c, new["pred_x0"])
            new["sample"] = new["mean"] + nz * std * reverse_eps

        g = self.cond_fn_sample(out, xt, c, generator)
        if g is not None:
            # as the reference: added to the ORIGINAL sample, not the re-propagated one
            new["sample"] = out["sample"] + g

        return new
