"""Flow matching (rectified flow): the velocity objective and its ODE samplers.

Counterpart of ``dmtpu/diffusions/flow.py``.  Time ``u`` runs from 0 (data)
to 1 (noise):

    x_u      = (1 - u) x0 + u eps
    target v = dx/du = eps - x0
    pred_x0  = x_u - u v

Sampling integrates ``dx/du = v(x, u)`` from u = 1 down to u = 0 over a
grid computed on the host in float64 and stored as float32 (``sampler_tape``);
``sample_loop`` is a Python loop over its rows, whose scalars are host
floats, so a step only enqueues work on the device.  Euler takes one model
call a step; Heun two, and applies its trapezoid correction on the last step
too (the velocity has no singularity at u = 0).

The model seam is ``model_fn(x, t, **model_kwargs) -> velocity`` with the
model conditioned on the FLOAT time ``t = u * total_steps`` (not rounded),
so a model of the DDPM zoo, which embeds integer-scale timesteps, trains
and samples as a flow model.  ``time_shift`` (SD3's resolution shift)
remaps ``u -> shift u / (1 + (shift - 1) u)`` in the training draw and on
the sampling grid.  Images are NCHW.

Classes: ``FlowMatching`` and ``FlowMatchingCFG`` (classifier-free guidance
as ONE model call on the doubled batch, ``v = (1 - s) v_uncond + s v_cond``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmtpu_torch.diffusions.ddpm import cfg_double_merge
from dmtpu_torch.utils import rows

ModelFn = Callable[..., torch.Tensor]
Row = Dict[str, float]


def _bcast(coef: torch.Tensor, ndim: int) -> torch.Tensor:
    return coef.reshape(coef.shape + (1,) * (ndim - coef.dim()))


def _shift_u(u, shift: float):
    """SD3 timestep shift: the identity at shift 1, mass pushed toward u = 1."""
    if shift == 1.0:
        return u
    return shift * u / (1.0 + (shift - 1.0) * u)


class FlowMatching:
    """Linear-interpolant flow matching: velocity training and ODE sampling.

    ``respace_type``: ``quad`` (grid = linspace**2, denser near the data end)
    or the uniform grid, which ``uniform``, ``uniform-leading``,
    ``uniform-trailing``, ``uniform2`` and ``linspace`` all name in
    continuous time; anything else raises.  ``solver``: ``euler`` or
    ``heun``.  ``clip_denoised`` clips the implied pred_x0 to [-1, 1] each
    step and re-derives the velocity from it.
    """

    _UNIFORM_TYPES = ("uniform", "uniform-leading", "uniform-trailing", "uniform2", "linspace")

    def __init__(self, total_steps: int = 1000, respace_steps: int = 50,
                 respace_type: str = "uniform", solver: str = "euler", time_shift: float = 1.0,
                 clip_denoised: bool = False, **_: Any):
        if solver not in ("euler", "heun"):
            raise ValueError(f"Invalid solver: {solver}")
        if time_shift <= 0:
            raise ValueError(f"time_shift must be > 0, got {time_shift}")
        respace_type = respace_type or "uniform"
        if respace_type not in self._UNIFORM_TYPES + ("quad",):
            raise ValueError(f"Invalid respace_type for flow matching: {respace_type!r} "
                             f"(supported: {self._UNIFORM_TYPES + ('quad',)})")
        self.total_steps = int(total_steps)
        self.respace_steps = int(respace_steps)
        self.respace_type = respace_type
        self.solver = solver
        self.time_shift = float(time_shift)
        self.clip_denoised = bool(clip_denoised)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _u_of_t(self, t: torch.Tensor) -> torch.Tensor:
        """Integer timestep -> (shifted) continuous time in [0, 1), f32."""
        return _shift_u(t.float() / float(self.total_steps), self.time_shift)

    def diffuse(self, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """x_u = (1 - u) x0 + u eps at the MODEL time ``t`` (u * total_steps,
        the scale of ``respaced_seq``'s rows, which carry the shift already)."""
        u = _bcast(torch.as_tensor(t, device=x0.device).float() / float(self.total_steps),
                   x0.dim())
        return (1.0 - u) * x0 + u * eps

    def loss_func(self, model_fn: ModelFn, x0: torch.Tensor, t: torch.Tensor,
                  eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  model_kwargs: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """f32 MSE of the model's velocity against eps - x0, at the integer
        timesteps ``t`` [B] in [0, total_steps) (the DDPM ``loss_func``
        contract); ``eps`` defaults to a standard normal from ``generator``."""
        if eps is None:
            eps = rows.randn(x0.shape, generator, x0.device, x0.dtype)
        u = _bcast(self._u_of_t(t.to(x0.device)), x0.dim())
        xu = (1.0 - u) * x0 + u * eps
        # the model sees the SHIFTED time, as in sampling
        pred = model_fn(xu, (u * float(self.total_steps)).reshape(x0.shape[0]),
                        **(model_kwargs or {}))
        return torch.mean(torch.square(pred.float() - (eps.float() - x0.float())))

    # ------------------------------------------------------------------
    # the sampling tape
    # ------------------------------------------------------------------
    @property
    def respaced_seq(self) -> np.ndarray:
        """The model-time grid, ascending (its length is the step count)."""
        u = self.sampler_tape()["u"]
        return np.ascontiguousarray((u * self.total_steps)[::-1])

    def sampler_tape(self) -> Dict[str, np.ndarray]:
        """Rows in sampling order: ``u`` (current) and ``u_next`` (< u); the
        shift is applied to the grid in float64, the endpoints stay exact."""
        grid = np.linspace(1.0, 0.0, self.respace_steps + 1, dtype=np.float64)
        if self.respace_type == "quad":
            grid = grid ** 2
        grid = _shift_u(grid, self.time_shift)
        return {"u": grid[:-1].astype(np.float32), "u_next": grid[1:].astype(np.float32)}

    @staticmethod
    def tape_rows(tape: Dict[str, np.ndarray]) -> list[Row]:
        """The tape as one dict of host scalars per step (exact f32 values)."""
        return [{k: v[i].item() for k, v in tape.items()} for i in range(len(tape["u"]))]

    # ------------------------------------------------------------------
    # one ODE step
    # ------------------------------------------------------------------
    def _t_batch(self, x: torch.Tensor, u: float) -> torch.Tensor:
        return torch.full((x.shape[0],), u * float(self.total_steps), dtype=torch.float32,
                          device=x.device)

    def _raw_velocity(self, model_fn: ModelFn, x: torch.Tensor, u: float,
                      model_kwargs: Dict[str, Any]) -> torch.Tensor:
        """One model call (the CFG subclass overrides only this)."""
        return model_fn(x, self._t_batch(x, u), **model_kwargs).float()

    def _velocity(self, model_fn: ModelFn, x: torch.Tensor, u: float,
                  model_kwargs: Dict[str, Any]) -> torch.Tensor:
        v = self._raw_velocity(model_fn, x, u, model_kwargs)
        if self.clip_denoised and u > 0:
            # at u = 0 the division is degenerate and the raw v passes through
            x0 = (x - u * v).clamp(-1.0, 1.0)
            v = (x - x0) / max(u, 1e-6)
        return v

    def ode_step(self, model_fn: ModelFn, x: torch.Tensor, c: Row,
                 model_kwargs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """x_u -> x_{u_next} with the configured solver."""
        u, u_next = c["u"], c["u_next"]
        du = float(np.float32(u_next) - np.float32(u))
        v1 = self._velocity(model_fn, x, u, model_kwargs)
        if self.solver == "euler":
            v = v1
        else:  # heun: the trapezoid over the Euler proposal
            v2 = self._velocity(model_fn, x + du * v1, u_next, model_kwargs)
            v = 0.5 * (v1 + v2)
        return {"sample": x + du * v, "pred_x0": x - u * v1, "velocity": v1}

    # ------------------------------------------------------------------
    # the sampling loop
    # ------------------------------------------------------------------
    def _run(self, model_fn: ModelFn, x: torch.Tensor, rows: Sequence[Row],
             model_kwargs: Dict[str, Any], collect: Sequence[str]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        ys: Dict[str, list] = {k: [] for k in collect}
        for c in rows:
            out = self.ode_step(model_fn, x, c, model_kwargs)
            for k in collect:
                ys[k].append(out[k])
            x = out["sample"]
        return x, {k: torch.stack(v) for k, v in ys.items()}

    def sample_loop(self, model_fn: ModelFn, init_noise: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    model_kwargs: Optional[Dict[str, Any]] = None, collect: Sequence[str] = (),
                    start_step: int = 0, num_steps: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Integrate from ``init_noise`` ([B, C, H, W]) over the tape rows
        ``start_step`` .. ``start_step + num_steps``.  Deterministic:
        ``generator`` is accepted for the samplers' common signature and
        unused.  Returns the final sample and, for each key of ``collect``
        (``sample``, ``pred_x0``, ``velocity``), the per-step values stacked."""
        rows = self.tape_rows(self.sampler_tape())
        stop = len(rows) if num_steps is None else min(len(rows), start_step + num_steps)
        return self._run(model_fn, init_noise.float(), rows[start_step:stop],
                         model_kwargs or {}, collect)

    def sample(self, model_fn: ModelFn, init_noise: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any) -> torch.Tensor:
        final, _ = self.sample_loop(model_fn, init_noise, generator, model_kwargs, **kwargs)
        return final

    def sample_inversion(self, model_fn: ModelFn, img: torch.Tensor,
                         model_kwargs: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Data -> noise: the same ODE over the tape reversed (u: 0 -> 1)."""
        fwd = self.sampler_tape()
        tape = {"u": fwd["u_next"][::-1], "u_next": fwd["u"][::-1]}
        final, _ = self._run(model_fn, img.float(), self.tape_rows(tape), model_kwargs or {}, ())
        return final


class FlowMatchingCFG(FlowMatching):
    """Classifier-free-guided flow sampling: ONE call on the doubled batch
    [cond | uncond] a velocity, ``v = (1 - s) v_uncond + s v_cond`` (the
    ``DDPMCFG`` convention applied to the velocity).  The clip hook of
    ``_velocity`` applies to the guided combination."""

    _UNCOND_KEY = "__cfg_uncond_conditioning__"

    def __init__(self, guidance_scale: float = 1.0, cond_kwarg: str = "y", *args: Any,
                 **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.guidance_scale = float(guidance_scale)
        self.cond_kwarg = cond_kwarg

    def _raw_velocity(self, model_fn, x, u, model_kwargs):
        x2, merged = cfg_double_merge(x, model_kwargs, self.cond_kwarg, self._UNCOND_KEY)
        v_cond, v_uncond = model_fn(x2, self._t_batch(x2, u), **merged).float().chunk(2)
        s = self.guidance_scale
        return (1.0 - s) * v_uncond + s * v_cond

    def _with_uncond(self, model_kwargs, uncond_conditioning) -> Dict[str, Any]:
        mk = dict(model_kwargs or {})
        mk[self._UNCOND_KEY] = uncond_conditioning
        return mk

    def sample_loop(self, model_fn: ModelFn, init_noise: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    uncond_conditioning: Any = None,
                    model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any):
        return super().sample_loop(model_fn, init_noise, generator,
                                   self._with_uncond(model_kwargs, uncond_conditioning), **kwargs)

    def sample(self, model_fn: ModelFn, init_noise: torch.Tensor,
               generator: Optional[torch.Generator] = None, uncond_conditioning: Any = None,
               model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any) -> torch.Tensor:
        final, _ = self.sample_loop(model_fn, init_noise, generator, uncond_conditioning,
                                    model_kwargs, **kwargs)
        return final

    def sample_inversion(self, model_fn: ModelFn, img: torch.Tensor,
                         uncond_conditioning: Any = None,
                         model_kwargs: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Guided data -> noise, with ``uncond_conditioning`` as in ``sample``."""
        return super().sample_inversion(model_fn, img,
                                        self._with_uncond(model_kwargs, uncond_conditioning))
