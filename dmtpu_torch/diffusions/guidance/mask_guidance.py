"""Mask guidance (inpainting) and RePaint resampling.

Counterpart of ``dmtpu/diffusions/guidance/mask_guidance.py``.  Each step
overwrites the known region with the ground truth noised to the current
level (reference: diffusions/guidance/mask_guidance.py:51-61).  RePaint's
non-monotone forward/backward schedule (reference: :70-135) is computed on
the host as a tape of (t1, t2, branch) rows; ``resample_loop`` walks it and
takes, row by row on the host, the denoise branch (model call and guidance)
or the one-step re-noise branch.

Images and latents are [B, C, H, W]; the mask is [B, 1, H, W], 1 = known.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmtpu_torch.diffusions.ddim import DDIMCFG
from dmtpu_torch.diffusions.ddpm import ModelFn, _randn
from dmtpu_torch.diffusions.guidance.base import BaseGuidance


class MaskGuidance(BaseGuidance):
    def __init__(self, masked_image: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None, *args: Any, **kwargs: Any):
        """masked_image: [B, C, H, W]; mask: [B, 1, H, W], 1 = known, 0 = unknown."""
        super().__init__(*args, **kwargs)
        self.masked_image = masked_image
        self.mask = mask

    def set_mask_and_image(self, masked_image: torch.Tensor, mask: torch.Tensor) -> None:
        self.masked_image = masked_image
        self.mask = mask

    def cond_fn_sample(self, out, xt, c, generator):
        if self.masked_image is None or self.mask is None:
            raise RuntimeError("Please call `set_mask_and_image()` before sampling.")
        img = self.masked_image.float()
        eps = _randn(img, generator)
        # noised to level t_prev; at the final step (t == 0) the clean image
        diffused = c["sqrt_ac_prev"] * img + c["sqrt_1m_ac_prev"] * eps
        noisy_known = c["nonzero"] * diffused + (1.0 - c["nonzero"]) * img
        return (noisy_known - out["sample"]) * self.mask.float()

    # ------------------------------------------------------------------
    # RePaint
    # ------------------------------------------------------------------
    def get_resample_seq(self, resample_r: int = 10, resample_j: int = 10) -> list:
        """RePaint's Fig. 9 jump schedule over the respaced sequence.
        (reference: diffusions/guidance/mask_guidance.py:111-135)"""
        t_T = len(self.respaced_seq)
        jumps = {}
        for j in range(0, t_T - resample_j, resample_j):
            jumps[j] = resample_r - 1
        t = t_T
        ts = []
        while t >= 1:
            t = t - 1
            ts.append(int(self.respaced_seq[t]))
            if jumps.get(t, 0) > 0:
                jumps[t] = jumps[t] - 1
                for _ in range(resample_j):
                    t = t + 1
                    ts.append(int(self.respaced_seq[t]))
        return ts

    def resample_tape(self, resample_r: int = 10, resample_j: int = 10) -> Dict[str, np.ndarray]:
        """Tape over consecutive (t1, t2) pairs with a denoise / renoise flag."""
        seq1 = self.get_resample_seq(resample_r, resample_j)
        seq2 = seq1[1:] + [-1]
        t1 = np.asarray(seq1, np.int64)
        t2 = np.asarray(seq2, np.int64)
        denoise = t1 > t2
        # denoise rows: the full coefficient set for (t1 -> t2)
        with np.errstate(invalid="ignore", divide="ignore"):
            tape = self.pair_tape(t1, t2)
        # renoise rows: q(x_{t2} | x_{t1}), one step forward
        # (reference: diffusions/guidance/mask_guidance.py:63-68)
        ac1 = self.alphas_cumprod[t1]
        ac2 = np.where(t2 < self.total_steps,
                       self.alphas_cumprod[np.minimum(np.maximum(t2, 0), self.total_steps - 1)],
                       0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            alphas_next = np.where(denoise, 1.0, ac2 / ac1)
        tape["renoise_sqrt_alpha"] = np.sqrt(np.maximum(alphas_next, 0.0)).astype(np.float32)
        tape["renoise_sqrt_1m_alpha"] = np.sqrt(
            np.maximum(1.0 - alphas_next, 0.0)).astype(np.float32)
        tape["is_denoise"] = denoise.astype(np.float32)
        # Renoise rows carry placeholder (t1 -> t2) denoise coefficients that
        # may be NaN or inf (t2 = t1 + 1 runs the chain backwards) and that the
        # loop never reads.  Scrub ONLY those rows, as the JAX package's tape
        # does: a non-finite coefficient on a *denoise* row is a real schedule
        # bug and must fail loudly.
        for k, v in tape.items():
            if v.dtype == np.int32 or k.startswith("renoise") or k == "is_denoise":
                continue
            finite = np.isfinite(v)
            if not np.all(finite | ~denoise):
                raise FloatingPointError(
                    f"non-finite '{k}' coefficient on a denoise row: "
                    f"rows {np.unique(np.argwhere(~finite & denoise)[:, 0])}")
            tape[k] = np.where(finite, v, 0.0).astype(v.dtype)
        return tape

    def resample_loop(
        self,
        model_fn: ModelFn,
        init_noise: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        resample_r: int = 10,
        resample_j: int = 10,
        model_kwargs: Optional[Dict[str, Any]] = None,
        collect: Sequence[str] = (),
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(reference: diffusions/guidance/mask_guidance.py:70-95)"""
        unsupported = [k for k in collect if k != "sample"]
        if unsupported:
            raise ValueError(
                f"resample_loop can only collect 'sample': {unsupported} are "
                "undefined on the schedule's renoise rows (no model call there)")
        model_kwargs = model_kwargs or {}
        x = init_noise.float()
        samples = []
        for c in self.tape_rows(self.resample_tape(resample_r, resample_j)):
            if c["is_denoise"] > 0.5:
                out = self._model_step(model_fn, x, c, generator, model_kwargs)
                x = self.apply_guidance(out, x, c, generator)["sample"]
            else:
                x = c["renoise_sqrt_alpha"] * x + c["renoise_sqrt_1m_alpha"] * _randn(x, generator)
            if collect:
                samples.append(x)
        return x, ({"sample": torch.stack(samples)} if collect else {})

    def resample(self, model_fn: ModelFn, init_noise: torch.Tensor,
                 generator: Optional[torch.Generator] = None, resample_r: int = 10,
                 resample_j: int = 10, model_kwargs: Optional[Dict[str, Any]] = None,
                 **kwargs: Any) -> torch.Tensor:
        final, _ = self.resample_loop(model_fn, init_noise, generator, resample_r, resample_j,
                                      model_kwargs, **kwargs)
        return final


class MaskGuidanceDDIMCFG(MaskGuidance, DDIMCFG):
    """Latent inpainting with classifier-free guidance.

    ``MaskGuidance`` contributes the per-step overwrite of the known region
    (``cond_fn_sample``), ``DDIMCFG`` the one doubled-batch model call and the
    DDIM step; they meet in the shared ``sample_loop`` / ``apply_guidance``
    seam.  The guidance state (``masked_image`` and ``mask``) has the
    undoubled batch.  A fully known mask gives back the known image exactly
    at t = 0.  ``dmtpu_torch.scripts.sample_sd`` uses it in latent space
    (``--inpaint_image`` / ``--inpaint_mask``, the mask downsampled to the
    latent grid).
    """
