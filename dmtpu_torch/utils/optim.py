"""Optimizer factories keyed by the reference's torch.optim targets.

Counterpart of ``dmtpu/utils/optim.py``, whose factories return optax
transformations; here each returns a ``torch.optim.Optimizer`` over the
given parameters, computing what the optax chain computes:

- ``adam``: bias-corrected Adam, ``eps`` outside the square root; with
  ``weight_decay`` the decay is decoupled and scaled by ``lr`` (optax's
  ``add_decayed_weights`` before ``scale_by_learning_rate``), which is
  ``torch.optim.AdamW``'s update.
- ``adamw``: the same with ``weight_decay=0.01``.
- ``adafactor``: ``Adafactor`` below, optax's ``adafactor`` with this repo's
  defaults.
- ``sgd``: ``torch.optim.SGD``, whose coupled weight decay and momentum
  buffer compute ``optax.chain(add_decayed_weights, sgd(momentum, nesterov))``.

``lr_fn`` gives the learning rate of a config's optimizer for logging.

Not ported, since no caller of the JAX factories sets them: a bf16 first
moment (``mu_dtype``), adafactor's momentum and parameter scaling, and
learning-rate schedules given as configs.
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch


def lr_fn(optim_conf: Mapping) -> Callable[[int], float]:
    """step -> the learning rate the optimizer of ``optim_conf`` applies, for
    logging, by the JAX function's rules: a config without ``lr`` logs 1e-3
    for the repo's factories (their default) and NaN for adafactor (no fixed
    step size) or an unknown target.  A schedule given as a config raises:
    schedules are not ported."""
    params = dict(optim_conf.get("params", None) or {})
    lr = params.get("lr", params.get("learning_rate"))
    if lr is None:
        target = str(optim_conf.get("target", ""))
        if "adafactor" not in target.lower() and \
                any(t in target for t in ("torch.optim.", "utils.optim.")):
            return lambda step: 1e-3
        return lambda step: float("nan")
    if isinstance(lr, Mapping):
        raise NotImplementedError("learning-rate schedules given as configs are not ported")
    return lambda step: float(lr)


def adam(params: Iterable, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0) -> torch.optim.Optimizer:
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)


def adamw(params: Iterable, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01) -> torch.optim.Optimizer:
    return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)


def sgd(params: Iterable, lr: float, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> torch.optim.Optimizer:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay,
                           nesterov=nesterov)


def adafactor(params: Iterable, lr: Optional[float] = None, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, clipping_threshold: Optional[float] = 1.0,
              weight_decay: float = 0.0, eps: float = 1e-30) -> "Adafactor":
    return Adafactor(params, lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
                     decay_rate=decay_rate, clipping_threshold=clipping_threshold,
                     weight_decay=weight_decay, eps=eps)


def factored_dims(shape: torch.Size, min_dim_size_to_factor: int) -> Optional[tuple[int, int]]:
    """(second largest dim, largest dim) when the second largest has at least
    ``min_dim_size_to_factor`` entries, else None (optax's ``_factored_dims``)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class Adafactor(torch.optim.Optimizer):
    """Adafactor (Shazeer & Stern, arXiv:1804.04235) as ``optax.adafactor``
    computes it with this repo's defaults (no momentum, no parameter
    scaling).  The second-moment statistics are kept in the parameter's
    dtype, as optax keeps them (in a dtype narrower than f32 each is decayed
    and summed in f32 and rounded once, as optax does), and the rest runs in
    the parameter's dtype (bf16 under MMDiT's ``param_dtype``), as optax's
    arithmetic does.  Per parameter and step n (from 0):

    1. second moment with decay 1 - (n + 1)^-decay_rate of g^2 + eps:
       factored into row and column means over the two largest dims when
       the second largest has >= ``min_dim_size_to_factor`` entries (the
       estimate is symmetric in the two, so OIHW and HWIO kernels agree),
       else kept whole; u = g / sqrt(estimate);
    2. u clipped to block RMS ``clipping_threshold``;
    3. times ``lr`` (none when ``lr`` is None);
    4. plus ``weight_decay * param`` (decoupled, not scaled by ``lr``);
    5. param -= u.
    """

    def __init__(self, params: Iterable, lr: Optional[float] = None,
                 min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
                 clipping_threshold: Optional[float] = 1.0, weight_decay: float = 0.0,
                 eps: float = 1e-30):
        defaults = dict(lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
                        decay_rate=decay_rate, clipping_threshold=clipping_threshold,
                        weight_decay=weight_decay, eps=eps)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(_init_state(p, group))
                p.sub_(_update(p, p.grad, state, group))
                state["step"] += 1
        return loss


def _init_state(p: torch.Tensor, group: dict) -> dict:
    dims = factored_dims(p.shape, group["min_dim_size_to_factor"])
    if dims is None:
        return {"step": 0, "v": torch.zeros_like(p)}
    d1, d0 = dims
    return {"step": 0, "v_row": torch.zeros_like(p.mean(d0)),
            "v_col": torch.zeros_like(p.mean(d1))}


def _update(p: torch.Tensor, g: torch.Tensor, state: dict, group: dict) -> torch.Tensor:
    # the decay in f32, as optax computes it
    n = np.float32(state["step"] + 1)
    decay = float(np.float32(1.0) - n ** np.float32(-group["decay_rate"]))
    g_sq = g.square().add_(group["eps"])

    def decayed(name: str, g_sq_mean: torch.Tensor) -> torch.Tensor:
        v = state[name]
        if v.dtype == torch.float32:  # in place: two launches
            return v.mul_(decay).add_(g_sq_mean, alpha=1.0 - decay)
        return v.copy_(decay * v.float() + (1.0 - decay) * g_sq_mean.float())

    dims = factored_dims(p.shape, group["min_dim_size_to_factor"])
    if dims is None:
        u = g * decayed("v", g_sq).rsqrt()
    else:
        d1, d0 = dims
        v_row, v_col = decayed("v_row", g_sq.mean(d0)), decayed("v_col", g_sq.mean(d1))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt()
        u = g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
    if group["clipping_threshold"] is not None:
        u.div_(torch.clamp(u.square().mean().sqrt() / group["clipping_threshold"], min=1.0))
    if group["lr"] is not None:
        u.mul_(group["lr"])
    if group["weight_decay"]:
        u.add_(p, alpha=group["weight_decay"])
    return u
