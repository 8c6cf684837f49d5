"""DDPM: the reverse-process math over a precomputed coefficient tape.

Counterpart of ``dmtpu/diffusions/ddpm.py`` (reference: diffusions/ddpm.py).
Every scalar a step needs is computed once on the host in float64 and
stored as float32 (``pair_tape`` / ``sampler_tape``, the same tables as the
JAX package).  ``sample_loop`` is a Python loop over the tape rows whose
coefficients are host floats, so a step never waits for the device: the
loop only enqueues work.  After each step it calls ``apply_guidance``, a
no-op here that ``dmtpu_torch.diffusions.guidance.BaseGuidance`` overrides;
every sampler shares this one loop, so every sampler has the seam.

The model seam is ``model_fn(xt, t_batch, **model_kwargs) -> output``.
Images are NCHW; output channels beyond ``xt``'s are a learned variance, so
the split is on dim 1 (the JAX package splits its last axis).  Noise comes
from an explicit ``torch.Generator``.

Classes: ``DDPM`` (ancestral sampling, ``set_respaced_seq``, the four
``pred_*`` conversions, and the training loss ``loss_func`` over
``diffuse`` / ``get_v``) and ``DDPMCFG`` (classifier-free
guidance as ONE model call on the doubled batch, with an optional
``guidance_interval``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dmtpu_torch.diffusions.schedule import get_beta_schedule, get_respaced_seq
from dmtpu_torch.utils import rows

ModelFn = Callable[..., torch.Tensor]
Row = Dict[str, float]

_OBJECTIVES = ("pred_eps", "pred_x0", "pred_v")
_VAR_TYPES = ("fixed_small", "fixed_large", "learned_range")


def _randn(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return rows.randn(like.shape, generator, like.device, torch.float32)


class DDPM:
    """Denoising Diffusion Probabilistic Models (sampling and the training loss)."""

    def __init__(
        self,
        total_steps: int = 1000,
        beta_schedule: str = "linear",
        beta_start: float = 0.0001,
        beta_end: float = 0.02,
        betas: Optional[np.ndarray] = None,
        objective: str = "pred_eps",
        var_type: str = "fixed_large",
        clip_denoised: bool = True,
        respace_type: Optional[str] = None,
        respace_steps: int = 100,
        respaced_seq: Optional[np.ndarray] = None,
        **_: Any,
    ):
        if objective not in _OBJECTIVES:
            raise ValueError(f"Invalid objective: {objective}")
        if var_type not in _VAR_TYPES:
            raise ValueError(f"Invalid var_type: {var_type}")
        self.total_steps = int(total_steps)
        self.objective = objective
        self.var_type = var_type
        self.clip_denoised = bool(clip_denoised)
        if betas is None:
            betas = get_beta_schedule(total_steps=total_steps, beta_schedule=beta_schedule,
                                      beta_start=beta_start, beta_end=beta_end)
        betas = np.asarray(betas, dtype=np.float64)
        if betas.shape != (self.total_steps,):
            raise ValueError(f"betas must have shape ({self.total_steps},), got {betas.shape}")
        self.alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        if respaced_seq is None:
            respaced_seq = get_respaced_seq(total_steps=total_steps, respace_type=respace_type,
                                            respace_steps=respace_steps)
        self.respaced_seq = np.asarray(respaced_seq, dtype=np.int64)
        if self.respaced_seq.ndim != 1:
            raise ValueError("respaced_seq must be 1-D")

    def set_respaced_seq(self, respace_type: str = "uniform", respace_steps: int = 100) -> None:
        """Respace the sampler to ``respace_steps`` steps (the tapes follow)."""
        self.respaced_seq = get_respaced_seq(total_steps=self.total_steps,
                                             respace_type=respace_type,
                                             respace_steps=respace_steps)

    # ------------------------------------------------------------------
    # forward process and training loss (reference: diffusions/ddpm.py:122-172)
    # ------------------------------------------------------------------
    def _gather(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """alphas_cumprod[t] as float32, shaped [B, 1, 1, ...] against ``like``."""
        table = torch.from_numpy(self.alphas_cumprod.astype(np.float32)).to(like.device)
        ac = table[torch.as_tensor(t).to(like.device).long()]
        return ac.reshape(ac.shape + (1,) * (like.dim() - ac.dim()))

    def pred_x0_from_eps(self, xt: torch.Tensor, t: torch.Tensor,
                         eps: torch.Tensor) -> torch.Tensor:
        ac = self._gather(t, xt)
        return torch.sqrt(1.0 / ac) * xt - torch.sqrt(1.0 / ac - 1.0) * eps

    def pred_eps_from_x0(self, xt: torch.Tensor, t: torch.Tensor,
                         x0: torch.Tensor) -> torch.Tensor:
        ac = self._gather(t, xt)
        return (torch.sqrt(1.0 / ac) * xt - x0) / torch.sqrt(1.0 / ac - 1.0)

    def pred_x0_from_v(self, xt: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        ac = self._gather(t, xt)
        return torch.sqrt(ac) * xt - torch.sqrt(1.0 - ac) * v

    def pred_eps_from_v(self, xt: torch.Tensor, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        ac = self._gather(t, xt)
        return torch.sqrt(1.0 - ac) * xt + torch.sqrt(ac) * v

    def diffuse(self, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """A sample of q(x_t | x_0): sqrt(ac) x0 + sqrt(1 - ac) eps."""
        ac = self._gather(t, x0)
        return torch.sqrt(ac) * x0 + torch.sqrt(1.0 - ac) * eps

    def get_v(self, x0: torch.Tensor, eps: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The v-prediction target sqrt(ac) eps - sqrt(1 - ac) x0."""
        ac = self._gather(t, x0)
        return torch.sqrt(ac) * eps - torch.sqrt(1.0 - ac) * x0

    def loss_func(self, model_fn: ModelFn, x0: torch.Tensor, t: torch.Tensor,
                  eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  model_kwargs: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """f32 MSE of the model output against eps, x0 or v (``objective``).
        ``eps`` defaults to a standard normal drawn from ``generator``."""
        if eps is None:
            eps = rows.randn(x0.shape, generator, x0.device, x0.dtype)
        xt = self.diffuse(x0, t, eps)
        pred = model_fn(xt, t, **(model_kwargs or {}))
        if self.objective == "pred_eps":
            target = eps
        elif self.objective == "pred_x0":
            target = x0
        else:
            target = self.get_v(x0, eps, t)
        return torch.mean(torch.square(pred.float() - target.float()))

    # ------------------------------------------------------------------
    # sampler tape: per-step scalars, float64 on host -> float32 arrays
    # ------------------------------------------------------------------
    def pair_tape(self, t: np.ndarray, t_prev: np.ndarray) -> Dict[str, np.ndarray]:
        """Coefficient rows for (t, t_prev) denoise pairs; ``t_prev = -1``
        means "to clean x0".  float64 arithmetic, float32 (int32 ``t``) out."""
        t = np.asarray(t, np.int64)
        t_prev = np.asarray(t_prev, np.int64)
        ac = self.alphas_cumprod[t]
        ac_prev = np.where(t_prev >= 0, self.alphas_cumprod[np.maximum(t_prev, 0)], 1.0)
        alphas_t = ac / ac_prev
        betas_t = 1.0 - alphas_t
        var_small = betas_t * (1.0 - ac_prev) / (1.0 - ac)
        tape = {
            "t": t.astype(np.int32),
            "nonzero": (t != 0).astype(np.float32),
            "ac": ac,
            "ac_prev": ac_prev,
            "sqrt_ac": np.sqrt(ac),
            "sqrt_1m_ac": np.sqrt(1.0 - ac),
            "sqrt_recip_ac": np.sqrt(1.0 / ac),
            "sqrt_recipm1_ac": np.sqrt(1.0 / ac - 1.0),
            "sqrt_ac_prev": np.sqrt(ac_prev),
            "sqrt_1m_ac_prev": np.sqrt(1.0 - ac_prev),
            "mean_coef1": np.sqrt(ac_prev) * betas_t / (1.0 - ac),
            "mean_coef2": np.sqrt(alphas_t) * (1.0 - ac_prev) / (1.0 - ac),
            "var_small": var_small,
            "var_large": betas_t,
            "min_logvar": np.log(np.maximum(var_small, 1e-20)),
            "max_logvar": np.log(np.maximum(betas_t, 1e-20)),
        }
        return {k: (v if v.dtype == np.int32 else v.astype(np.float32)) for k, v in tape.items()}

    def sampler_tape(self) -> Dict[str, np.ndarray]:
        """Per-step coefficients in sampling order (t descending): row i is
        the step t = seq[-1-i] -> the previous respaced step (or -1)."""
        seq = self.respaced_seq
        seq_prev = np.concatenate([[-1], seq[:-1]])
        return self.pair_tape(seq[::-1], seq_prev[::-1])

    @staticmethod
    def tape_rows(tape: Dict[str, np.ndarray]) -> list[Row]:
        """The tape as one dict of host scalars per step (exact f32 values)."""
        n = len(tape["t"])
        return [{k: v[i].item() for k, v in tape.items()} for i in range(n)]

    # ------------------------------------------------------------------
    # single reverse step
    # ------------------------------------------------------------------
    def predict(self, model_output: torch.Tensor, xt: torch.Tensor, c: Row,
                objective: Optional[str] = None) -> Dict[str, Optional[torch.Tensor]]:
        """x0 / eps predictions from the model output at one tape row ``c``."""
        objective = objective or self.objective
        learned_var = None
        ch = xt.shape[1]
        if model_output.shape[1] > ch:
            model_output, learned_var = model_output[:, :ch], model_output[:, ch:]
        model_output = model_output.float()
        if objective == "pred_eps":
            pred_x0 = c["sqrt_recip_ac"] * xt - c["sqrt_recipm1_ac"] * model_output
        elif objective == "pred_x0":
            pred_x0 = model_output
        elif objective == "pred_v":
            pred_x0 = c["sqrt_ac"] * xt - c["sqrt_1m_ac"] * model_output
        else:
            raise ValueError(f"Invalid objective: {objective}")
        if self.clip_denoised:
            pred_x0 = pred_x0.clamp(-1.0, 1.0)
        pred_eps = (c["sqrt_recip_ac"] * xt - pred_x0) / c["sqrt_recipm1_ac"]
        return {"pred_x0": pred_x0, "pred_eps": pred_eps, "learned_var": learned_var}

    def denoise_step(self, model_output: torch.Tensor, xt: torch.Tensor, c: Row,
                     generator: Optional[torch.Generator] = None,
                     objective: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """One ancestral step p(x_{t-1} | x_t); ``t == 0`` rows add no noise."""
        p = self.predict(model_output, xt, c, objective=objective)
        pred_x0, pred_eps, learned_var = p["pred_x0"], p["pred_eps"], p["learned_var"]
        mean = c["mean_coef1"] * pred_x0 + c["mean_coef2"] * xt
        if self.var_type == "fixed_small":
            var = c["var_small"]
            std = var ** 0.5
        elif self.var_type == "fixed_large":
            var = c["var_large"]
            std = var ** 0.5
        else:  # learned_range
            if learned_var is None:
                raise ValueError("var_type='learned_range' requires extra model output channels")
            frac = (learned_var.float() + 1.0) / 2.0
            logvar = frac * c["max_logvar"] + (1.0 - frac) * c["min_logvar"]
            var = torch.exp(logvar)
            std = torch.exp(0.5 * logvar)
        nz = c["nonzero"]
        reverse_eps = _randn(xt, generator)
        return {
            "sample": mean + nz * std * reverse_eps,
            "mean": mean,
            "var": var * nz,
            "pred_x0": pred_x0,
            "pred_eps": pred_eps,
            "reverse_eps": reverse_eps,
        }

    def apply_guidance(self, out: Dict[str, torch.Tensor], xt: torch.Tensor, c: Row,
                       generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The guidance seam: a step's outputs, transformed.  ``BaseGuidance``
        overrides it.  (reference: diffusions/guidance/base.py:74-142)"""
        return out

    # ------------------------------------------------------------------
    # the sampling loop
    # ------------------------------------------------------------------
    def _model_step(self, model_fn: ModelFn, xt: torch.Tensor, c: Row,
                    generator: Optional[torch.Generator],
                    model_kwargs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Model call + denoise for one tape row.  Subclasses (CFG) override."""
        t_batch = torch.full((xt.shape[0],), c["t"], dtype=torch.int64, device=xt.device)
        return self.denoise_step(model_fn(xt, t_batch, **model_kwargs), xt, c, generator)

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
        """Run the reverse process from ``init_noise`` ([B, C, H, W]).

        ``start_step`` skips the first tape rows (SDEdit-style partial
        denoising) and ``num_steps`` bounds how many rows run.  Returns the
        final sample and, for each key in ``collect``, the per-step values
        stacked on a new leading axis.
        """
        model_kwargs = model_kwargs or {}
        rows = self.tape_rows(self.sampler_tape())
        stop = len(rows) if num_steps is None else min(len(rows), start_step + num_steps)
        x = init_noise.float()
        ys: Dict[str, list] = {k: [] for k in collect}
        for c in rows[start_step:stop]:
            out = self._model_step(model_fn, x, c, generator, model_kwargs)
            out = self.apply_guidance(out, x, c, generator)
            for k in collect:
                ys[k].append(out[k])
            x = out["sample"]
        return x, {k: torch.stack(v) for k, v in ys.items()}

    def sample(self, model_fn: ModelFn, init_noise: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any) -> torch.Tensor:
        """Final-sample-only convenience wrapper."""
        final, _ = self.sample_loop(model_fn, init_noise, generator, model_kwargs, **kwargs)
        return final


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples (``jax.tree.map``
    for the conditioning pytrees the CFG merge sees); ``rest`` are trees of the
    same structure whose leaves are passed alongside."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def cfg_double_merge(x: torch.Tensor, model_kwargs: Dict[str, Any], cond_kwarg: str,
                     uncond_key: str) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(x2, merged kwargs) for the ONE 2B-batched CFG call: [cond | uncond].

    The conditioning is a tensor or a pytree of them (MMDiT's ``{"context",
    "pooled"}``): cond and uncond are concatenated leaf by leaf.  Other
    ``model_kwargs`` are carried onto the doubled batch by the JAX package's
    heuristic: a tensor leaf with ``shape[0] == B`` is treated as per-sample
    and tiled to 2B.  Raises if the conditional kwarg or the unconditional
    entry is missing.
    """
    if cond_kwarg not in model_kwargs:
        raise ValueError(f"Condition argument `{cond_kwarg}` not found in model_kwargs.")
    uncond = model_kwargs.get(uncond_key)
    if uncond is None:
        raise ValueError(
            "CFG sampling requires `uncond_conditioning` (a null class index / "
            f"empty-prompt embedding pytree matching the conditional `{cond_kwarg}`); got None.")
    b = x.shape[0]

    def _double(a):
        if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == b:
            return torch.cat([a, a], dim=0)
        return a

    merged = {k: _tree_map(_double, v) for k, v in model_kwargs.items() if k != uncond_key}
    merged[cond_kwarg] = _tree_map(lambda c, u: torch.cat([c, u], dim=0),
                                   model_kwargs[cond_kwarg], uncond)
    return torch.cat([x, x], dim=0), merged


class DDPMCFG(DDPM):
    """DDPM with classifier-free guidance (s=0 uncond, s=1 conditional).

    The conditional and unconditional branches run as ONE model call on the
    doubled batch.  ``guidance_interval=(t_lo, t_hi)`` guides only the steps
    whose original timestep satisfies ``t_lo < t <= t_hi``; the other steps
    run one plain conditional B-sized call.  The choice is made on the host
    from the tape row, so it costs no device sync.
    """

    #: reserved model_kwargs key that carries the unconditional branch's
    #: conditioning; never passed to the model.
    _UNCOND_KEY = "__cfg_uncond_conditioning__"

    def __init__(self, guidance_scale: float = 1.0, cond_kwarg: str = "y", *args: Any,
                 guidance_interval: Optional[Tuple[float, float]] = None, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.guidance_scale = float(guidance_scale)
        self.cond_kwarg = cond_kwarg
        if guidance_interval is not None:
            lo, hi = guidance_interval
            if not lo < hi:
                raise ValueError(f"guidance_interval needs t_lo < t_hi, got {guidance_interval}")
            guidance_interval = (float(lo), float(hi))
        self.guidance_interval = guidance_interval

    def _cfg_model_output(self, model_fn: ModelFn, xt: torch.Tensor, c: Row,
                          model_kwargs: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(combined pred_eps, conditional model output) for one step."""
        x2, merged = cfg_double_merge(xt, model_kwargs, self.cond_kwarg, self._UNCOND_KEY)
        t2 = torch.full((x2.shape[0],), c["t"], dtype=torch.int64, device=xt.device)
        out_cond, out_uncond = model_fn(x2, t2, **merged).chunk(2, dim=0)
        eps_cond = self.predict(out_cond, xt, c)["pred_eps"]
        eps_uncond = self.predict(out_uncond, xt, c)["pred_eps"]
        s = self.guidance_scale
        return (1.0 - s) * eps_uncond + s * eps_cond, out_cond

    def _cond_only_model_output(self, model_fn: ModelFn, xt: torch.Tensor, c: Row,
                                model_kwargs: Dict[str, Any]):
        """One plain conditional call: the unguided steps of an interval."""
        merged = {k: v for k, v in model_kwargs.items() if k != self._UNCOND_KEY}
        t_b = torch.full((xt.shape[0],), c["t"], dtype=torch.int64, device=xt.device)
        out = model_fn(xt, t_b, **merged)
        return self.predict(out, xt, c)["pred_eps"], out

    def _model_step(self, model_fn, xt, c, generator, model_kwargs):
        guide = self.guidance_interval is None or (
            self.guidance_interval[0] < c["t"] <= self.guidance_interval[1])
        if guide:
            pred_eps, out_cond = self._cfg_model_output(model_fn, xt, c, model_kwargs)
        else:
            pred_eps, out_cond = self._cond_only_model_output(model_fn, xt, c, model_kwargs)
        if self.var_type == "learned_range":
            # the learned variance rides along from the conditional branch
            pred_eps = torch.cat([pred_eps, out_cond[:, xt.shape[1]:]], dim=1)
        return self.denoise_step(pred_eps, xt, c, generator, objective="pred_eps")

    def sample_loop(self, model_fn: ModelFn, init_noise: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    uncond_conditioning: Any = None,
                    model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any):
        mk = dict(model_kwargs or {})
        mk[self._UNCOND_KEY] = uncond_conditioning
        return super().sample_loop(model_fn, init_noise, generator, mk, **kwargs)

    def sample(self, model_fn: ModelFn, init_noise: torch.Tensor,
               generator: Optional[torch.Generator] = None, uncond_conditioning: Any = None,
               model_kwargs: Optional[Dict[str, Any]] = None, **kwargs: Any) -> torch.Tensor:
        final, _ = self.sample_loop(model_fn, init_noise, generator, uncond_conditioning,
                                    model_kwargs, **kwargs)
        return final
