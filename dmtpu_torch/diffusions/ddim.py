"""DDIM sampler and its classifier-free-guidance variant.

Counterpart of ``dmtpu/diffusions/ddim.py`` (reference: diffusions/ddim.py):
the DDIM variance and direction scalars are precomputed in float64 and
appended to the tape, and DDIM inversion (x_t -> x_{t+1}, eta = 0) runs over
its own ascending tape; ``DDIMCFG`` inverts with the guided eps.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmtpu_torch.diffusions.ddpm import DDPM, DDPMCFG, ModelFn, Row, _randn


class DDIM(DDPM):
    """Denoising Diffusion Implicit Models.  (reference: diffusions/ddim.py:12-86)"""

    def __init__(self, *args: Any, eta: float = 0.0, **kwargs: Any):
        kwargs.setdefault("var_type", "fixed_small")  # unused by the step math
        super().__init__(*args, **kwargs)
        self.eta = float(eta)

    def sampler_tape(self) -> Dict[str, np.ndarray]:
        tape = super().sampler_tape()
        seq = self.respaced_seq
        ac = self.alphas_cumprod[seq]
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        var = (self.eta ** 2) * (1.0 - ac_prev) / (1.0 - ac) * (1.0 - ac / ac_prev)
        dir_coef = np.sqrt(np.maximum(1.0 - ac_prev - var, 0.0))
        tape["ddim_var"] = var[::-1].astype(np.float32)
        tape["ddim_std"] = np.sqrt(var)[::-1].astype(np.float32)
        tape["ddim_dir_coef"] = dir_coef[::-1].astype(np.float32)
        return tape

    def denoise_step(self, model_output, xt, c, generator=None, objective=None):
        p = self.predict(model_output, xt, c, objective=objective)
        pred_x0, pred_eps = p["pred_x0"], p["pred_eps"]
        mean = c["sqrt_ac_prev"] * pred_x0 + c["ddim_dir_coef"] * pred_eps
        if self.eta == 0.0:
            # deterministic: no noise is drawn
            reverse_eps = torch.zeros_like(mean)
            sample = mean
        else:
            reverse_eps = _randn(xt, generator)
            sample = mean + c["nonzero"] * c["ddim_std"] * reverse_eps
        return {
            "sample": sample,
            "mean": mean,
            "var": c["ddim_var"],
            "pred_x0": pred_x0,
            "pred_eps": pred_eps,
            "reverse_eps": reverse_eps,
        }

    # ------------------------------------------------------------------
    # DDIM inversion: x_t -> x_{t+1} (eta = 0 only)
    # ------------------------------------------------------------------
    def inversion_tape(self) -> Dict[str, np.ndarray]:
        """Per-step coefficients of the inversion, ascending: row i is
        t = seq[i] -> t_next = seq[i + 1] (reference: diffusions/ddim.py:106-123)."""
        seq, ac = self.respaced_seq, self.alphas_cumprod
        ac_t, ac_next = ac[seq[:-1]], ac[seq[1:]]
        return {
            "t": seq[:-1].astype(np.int32),
            "sqrt_ac": np.sqrt(ac_t).astype(np.float32),
            "sqrt_1m_ac": np.sqrt(1.0 - ac_t).astype(np.float32),
            "sqrt_recip_ac": np.sqrt(1.0 / ac_t).astype(np.float32),
            "sqrt_recipm1_ac": np.sqrt(1.0 / ac_t - 1.0).astype(np.float32),
            "sqrt_ac_next": np.sqrt(ac_next).astype(np.float32),
            "sqrt_1m_ac_next": np.sqrt(1.0 - ac_next).astype(np.float32),
        }

    def _inversion_model_output(self, model_fn: ModelFn, xt: torch.Tensor, c: Row,
                                model_kwargs: Dict[str, Any]) -> torch.Tensor:
        t_batch = torch.full((xt.shape[0],), c["t"], dtype=torch.int64, device=xt.device)
        return model_fn(xt, t_batch, **model_kwargs)

    def _inversion_objective(self) -> Optional[str]:
        return None

    def _inversion_step(self, model_fn: ModelFn, xt: torch.Tensor, c: Row,
                        model_kwargs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """x_t -> x_{t+1}.  (reference: diffusions/ddim.py:88-104)"""
        out = self._inversion_model_output(model_fn, xt, c, model_kwargs)
        p = self.predict(out, xt, c, objective=self._inversion_objective())
        sample = c["sqrt_ac_next"] * p["pred_x0"] + c["sqrt_1m_ac_next"] * p["pred_eps"]
        return {"sample": sample, "pred_x0": p["pred_x0"], "pred_eps": p["pred_eps"]}

    def sample_inversion_loop(self, model_fn: ModelFn, img: torch.Tensor,
                              model_kwargs: Optional[Dict[str, Any]] = None,
                              collect: Sequence[str] = ()
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Invert ``img`` ([B, C, H, W]) to the noise the sampler maps onto
        it; ``collect`` stacks per-step ``sample`` / ``pred_x0`` / ``pred_eps``."""
        if self.eta != 0.0:
            raise ValueError(f"DDIM inversion is only valid when eta=0, got {self.eta}")
        model_kwargs = model_kwargs or {}
        x = img.float()
        ys: Dict[str, list] = {k: [] for k in collect}
        for c in self.tape_rows(self.inversion_tape()):
            out = self._inversion_step(model_fn, x, c, model_kwargs)
            for k in collect:
                ys[k].append(out[k])
            x = out["sample"]
        return x, {k: torch.stack(v) for k, v in ys.items()}

    def sample_inversion(self, model_fn: ModelFn, img: torch.Tensor,
                         model_kwargs: Optional[Dict[str, Any]] = None,
                         **kwargs: Any) -> torch.Tensor:
        final, _ = self.sample_inversion_loop(model_fn, img, model_kwargs, **kwargs)
        return final


class DDIMCFG(DDIM, DDPMCFG):
    """DDIM with classifier-free guidance (reference: diffusions/ddim.py:135-250):
    the batched two-branch model call of ``DDPMCFG`` with the step math of
    ``DDIM``."""

    def __init__(self, guidance_scale: float = 1.0, cond_kwarg: str = "y", *args: Any,
                 eta: float = 0.0, **kwargs: Any):
        super().__init__(*args, eta=eta, guidance_scale=guidance_scale,
                         cond_kwarg=cond_kwarg, **kwargs)

    def _inversion_objective(self) -> str:
        return "pred_eps"

    def _inversion_model_output(self, model_fn, xt, c, model_kwargs):
        pred_eps, _ = self._cfg_model_output(model_fn, xt, c, model_kwargs)
        return pred_eps

    def sample_inversion_loop(self, model_fn: ModelFn, img: torch.Tensor,
                              uncond_conditioning: Any = None,
                              model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any):
        """Guided inversion, with ``uncond_conditioning`` as in ``sample``.
        (reference: diffusions/ddim.py:141-171)"""
        mk = dict(model_kwargs or {})
        mk[self._UNCOND_KEY] = uncond_conditioning
        return DDIM.sample_inversion_loop(self, model_fn, img, mk, **kwargs)

    def sample_inversion(self, model_fn: ModelFn, img: torch.Tensor,
                         uncond_conditioning: Any = None,
                         model_kwargs: Optional[Dict[str, Any]] = None,
                         **kwargs: Any) -> torch.Tensor:
        final, _ = self.sample_inversion_loop(model_fn, img, uncond_conditioning, model_kwargs,
                                              **kwargs)
        return final
