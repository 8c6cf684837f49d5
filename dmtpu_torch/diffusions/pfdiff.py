"""PFDiff-1: sampler acceleration from past and future scores.

Counterpart of ``dmtpu/diffusions/pfdiff.py`` ("PFDiff: Training-Free
Acceleration of Diffusion Models Combining Past and Future Scores",
arXiv:2408.08822).  Eps predictions at adjacent timesteps are highly
correlated, so one model call covers TWO grid transitions:

    1. springboard:  jump t_i -> t_{i+1} with the BUFFERED eps of the
       previous iteration (no model call);
    2. future score: call the model at the springboard (t_{i+1});
    3. foresight:    update the ORIGINAL x_{t_i} -> x_{t_{i+2}} with that eps.

On a respaced grid of S steps this costs 1 (anchor) + floor((S-1)/2) +
((S-1) % 2) model calls.  The three coefficient rows a pair needs
(springboard, mid-point predict, full jump) come from ``DDPM.pair_tape`` in
float64 on the host; the loop runs over host-float rows.  Deterministic
(DDIM eta = 0): no noise is drawn.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmtpu_torch.diffusions.ddim import DDIM, DDIMCFG
from dmtpu_torch.diffusions.ddpm import ModelFn, Row

Tape = Dict[str, np.ndarray]


class PFDiffDDIM(DDIM):
    """PFDiff-1 over the deterministic DDIM solver (eta = 0 only)."""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        if self.eta != 0.0:
            raise ValueError(f"PFDiff requires the deterministic DDIM solver (eta=0), "
                             f"got eta={self.eta}")

    def pfdiff_tapes(self) -> Tuple[Tape, Optional[Tape], Optional[Tape], Optional[Tape],
                                    Optional[Tape]]:
        """(anchor, spring[K], mid[K], full[K], trail) coefficient rows.

        Positions 0..S-1 are the respaced timesteps in sampling order
        (t descending); position S is clean (-1).  The anchor is the plain
        DDIM step 0 -> 1; pair k starts at position i = 1 + 2k and covers
        i -> i+2 with one model call at i+1; a trailing plain step covers
        the last transition when S is even.
        """
        ext = np.concatenate([self.respaced_seq[::-1], [-1]])  # [S+1]
        S = len(ext) - 1
        anchor = self.pair_tape(ext[0:1], ext[1:2])
        if S == 1:
            return anchor, None, None, None, None

        starts = np.arange(1, S - 1, 2)  # pair start positions i (i+2 <= S)
        spring = mid = full = None
        if len(starts):
            spring = self.pair_tape(ext[starts], ext[starts + 1])
            mid = self.pair_tape(ext[starts + 1], ext[starts + 2])
            full = self.pair_tape(ext[starts], ext[starts + 2])
        i_end = 1 + 2 * len(starts)
        trail = None
        if i_end == S - 1:  # one transition left: a plain DDIM step
            trail = self.pair_tape(ext[i_end:i_end + 1], ext[i_end + 1:i_end + 2])
        return anchor, spring, mid, full, trail

    @property
    def nfe(self) -> int:
        """Model calls one ``sample`` costs (DDIM's: S)."""
        S = len(self.respaced_seq)
        return 1 + max(0, (S - 1) // 2) + ((S - 1) % 2 if S > 1 else 0)

    def _jump_with_eps(self, eps: torch.Tensor, x: torch.Tensor,
                       c: Row) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The deterministic DDIM jump from row ``c``'s t to its t_prev given
        eps at t, through ``predict`` (so ``clip_denoised`` holds here too)."""
        p = self.predict(eps, x, c, objective="pred_eps")
        x_next = c["sqrt_ac_prev"] * p["pred_x0"] + c["sqrt_1m_ac_prev"] * p["pred_eps"]
        return x_next, p

    def _eps_at(self, model_fn: ModelFn, x: torch.Tensor, c: Row,
                model_kwargs: Dict[str, Any]) -> torch.Tensor:
        """One model call at row ``c``'s t, as eps."""
        t_batch = torch.full((x.shape[0],), c["t"], dtype=torch.int64, device=x.device)
        return self.predict(model_fn(x, t_batch, **model_kwargs), x, c)["pred_eps"]

    def sample_loop(
        self,
        model_fn: ModelFn,
        init_noise: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        model_kwargs: Optional[Dict[str, Any]] = None,
        collect: Sequence[str] = (),
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The anchor step, then one model call a pair, then the trailing step.

        ``collect`` stacks the outputs of each pair's foresight update and of
        the trailing step (``sample`` / ``pred_x0`` / ``pred_eps``): the
        leading axis counts pairs, not S.  ``generator`` is accepted and
        unused.
        """
        model_kwargs = model_kwargs or {}
        anchor, spring, mid, full, trail = self.pfdiff_tapes()
        x = init_noise.float()
        c0 = self.tape_rows(anchor)[0]
        eps = self._eps_at(model_fn, x, c0, model_kwargs)
        x, _ = self._jump_with_eps(eps, x, c0)

        ys: Dict[str, list] = {k: [] for k in collect}

        def keep(x_next, p):
            out = {"sample": x_next, "pred_x0": p["pred_x0"], "pred_eps": p["pred_eps"]}
            for k in collect:
                ys[k].append(out[k])

        if spring is not None:
            for cs, cm, cf in zip(*(self.tape_rows(t) for t in (spring, mid, full))):
                x_spring, _ = self._jump_with_eps(eps, x, cs)
                eps = self._eps_at(model_fn, x_spring, cm, model_kwargs)
                x, p = self._jump_with_eps(eps, x, cf)
                keep(x, p)
        if trail is not None:
            ct = self.tape_rows(trail)[0]
            x, p = self._jump_with_eps(self._eps_at(model_fn, x, ct, model_kwargs), x, ct)
            keep(x, p)
        return x, {k: torch.stack(v) if v else x.new_zeros((0,) + x.shape)
                   for k, v in ys.items()}

    def sample(self, model_fn: ModelFn, init_noise: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any) -> torch.Tensor:
        final, _ = self.sample_loop(model_fn, init_noise, generator, model_kwargs, **kwargs)
        return final


class PFDiffDDIMCFG(PFDiffDDIM, DDIMCFG):
    """PFDiff-1 with classifier-free guidance: the buffered and future scores
    are the GUIDED eps, from ``DDPMCFG``'s one doubled-batch call."""

    def __init__(self, *args: Any, **kwargs: Any):
        if kwargs.get("guidance_interval") is not None:
            # the interval gate lives in DDPMCFG._model_step, which PFDiff
            # does not call: refuse rather than ignore it
            raise NotImplementedError(
                "guidance_interval is supported by DDPMCFG/DDIMCFG only; the "
                "PFDiff score buffer here needs interval-aware rework")
        super().__init__(*args, **kwargs)

    def _eps_at(self, model_fn, x, c, model_kwargs):
        pred_eps, _ = self._cfg_model_output(model_fn, x, c, model_kwargs)
        return pred_eps

    # Required, not redundant: without them the MRO resolves sample_loop and
    # sample to PFDiffDDIM's, whose fourth argument is model_kwargs, and
    # uncond_conditioning would silently land there.
    def sample_loop(self, model_fn: ModelFn, init_noise: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    uncond_conditioning: Any = None,
                    model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any):
        mk = dict(model_kwargs or {})
        mk[self._UNCOND_KEY] = uncond_conditioning
        return PFDiffDDIM.sample_loop(self, model_fn, init_noise, generator, mk, **kwargs)

    def sample(self, model_fn: ModelFn, init_noise: torch.Tensor,
               generator: Optional[torch.Generator] = None, uncond_conditioning: Any = None,
               model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any) -> torch.Tensor:
        final, _ = self.sample_loop(model_fn, init_noise, generator, uncond_conditioning,
                                    model_kwargs, **kwargs)
        return final
