"""Optimizer factories keyed by the reference's torch.optim targets.

Counterpart of ``dmtpu/utils/optim.py``, whose factories return optax
transformations; here each returns a ``torch.optim.Optimizer`` over the
given parameters, computing what the optax chain computes:

- ``adam``: bias-corrected Adam, ``eps`` outside the square root; with
  ``weight_decay`` the decay is decoupled and scaled by ``lr`` (optax's
  ``add_decayed_weights`` before ``scale_by_learning_rate``), which is
  ``torch.optim.AdamW``'s update.  With ``mu_dtype`` (a dtype or its name:
  ``"bfloat16"`` / ``"bf16"``, ``"float32"`` / ``"f32"``) the first moment
  is stored in that dtype and the update is ``Adam`` below, optax's
  ``scale_by_adam`` step by step; with ``mu_dtype=None`` it is
  ``torch.optim.Adam`` / ``AdamW``.
- ``adamw``: the same with ``weight_decay=0.01``.
- ``adafactor``: ``Adafactor`` below, optax's ``adafactor`` with this repo's
  defaults (no momentum, no parameter scaling), each of which a config may
  turn on (``momentum``, ``momentum_dtype``, ``multiply_by_parameter_scale``).
- ``sgd``: ``torch.optim.SGD``, whose coupled weight decay and momentum
  buffer compute ``optax.chain(add_decayed_weights, sgd(momentum, nesterov))``.

Each factory's ``lr`` is a number or a ``{target:, params:}`` schedule
config naming one of optax's schedules (``SCHEDULES``: the same formulas,
computed in f32 as optax computes them, without importing optax; any other
target raises ``ValueError``).  A scheduled optimizer sets every param
group's ``lr`` to ``schedule(k)`` before its update k, counting applied
updates from 0 as optax's ``count`` does (not micro-batches), and keeps k in
its param groups (``lr_updates``), so a resumed run goes on where it stopped.

``lr_fn`` gives the learning rate of a config's optimizer for logging.

A state kept in a dtype of its own (``Adam``'s first moment, ``Adafactor``'s
momentum) keeps it through ``load_state_dict``, which would otherwise cast
it to its parameter's dtype.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch

from dmtpu_torch.models.ema import as_dtype


Schedule = Callable[[int], float]
_f32 = np.float32


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(value)


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int, transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count: int) -> float:
        frac = _f32(1) - _f32(min(max(count - transition_begin, 0), transition_steps)) \
            / _f32(transition_steps)
        return float(_f32(init_value - end_value) * frac ** _f32(power)
                     + _f32(end_value))

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps, transition_begin)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * _f32(min(count, decay_steps))
                                               / _f32(decay_steps)))
        return float(_f32(init_value) * ((_f32(1) - _f32(alpha)) * cosine ** _f32(exponent)
                                         + _f32(alpha)))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """A linear warmup to ``peak_value``, then a cosine decay over the steps
    up to ``decay_steps`` (optax joins the two at ``warmup_steps``)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      transition_begin: int = 0, staircase: bool = False,
                      end_value: Optional[float] = None) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)
    clip = max if decay_rate < 1.0 else min

    def schedule(count: int) -> float:
        decreased = count - transition_begin
        if decreased <= 0:
            value = _f32(init_value)
        else:
            p = _f32(decreased) / _f32(transition_steps)
            value = _f32(init_value) * _f32(decay_rate) ** (np.floor(p) if staircase else p)
        return float(value if end_value is None else clip(value, _f32(end_value)))

    return schedule


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Optional[Mapping] = None) -> Schedule:
    pairs = sorted((int(b), float(s)) for b, s in (boundaries_and_scales or {}).items())
    if any(scale < 0.0 for _, scale in pairs):
        raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")

    def schedule(count: int) -> float:
        value = _f32(init_value)
        for boundary, scale in pairs:
            if count >= boundary:
                value = _f32(scale) * value
        return float(value)

    return schedule


# the schedule targets a config may name, as the JAX factories instantiate them
SCHEDULES = {f"optax.{fn.__name__}": fn for fn in (
    constant_schedule, linear_schedule, polynomial_schedule, cosine_decay_schedule,
    warmup_cosine_decay_schedule, exponential_decay, piecewise_constant_schedule)}


def build_schedule(conf: Mapping) -> Schedule:
    """The step -> lr function of a ``{target:, params:}`` schedule config."""
    target = str(conf["target"]).replace("optax.schedules.", "optax.")
    if target not in SCHEDULES:
        raise ValueError(f"learning-rate schedule {conf['target']!r} is not one of the "
                         f"supported optax schedules: {sorted(SCHEDULES)}")
    return SCHEDULES[target](**dict(conf.get("params", None) or {}))


def _resolve_lr(lr) -> tuple[Optional[float], Optional[Schedule]]:
    """(the lr of update 0, the schedule) of a number or a schedule config."""
    if isinstance(lr, Mapping):
        schedule = build_schedule(lr)
        return schedule(0), schedule
    return (None if lr is None else float(lr)), None


def scheduled(optimizer: torch.optim.Optimizer,
              schedule: Optional[Schedule]) -> torch.optim.Optimizer:
    """``optimizer`` with each param group's lr set to ``schedule(k)`` before
    its update k (k kept in the group as ``lr_updates``); unchanged when
    ``schedule`` is None.  ``optimizer.lr_schedule`` is the schedule."""
    optimizer.lr_schedule = schedule
    if schedule is None:
        return optimizer
    for group in optimizer.param_groups:
        group.setdefault("lr_updates", 0)

    def set_lr(opt, args, kwargs) -> None:
        for group in opt.param_groups:
            group["lr"] = schedule(group["lr_updates"])
            group["lr_updates"] += 1

    optimizer.register_step_pre_hook(set_lr)
    return optimizer


def lr_fn(optim_conf: Mapping) -> Callable[[int], float]:
    """step -> the learning rate the optimizer of ``optim_conf`` applies, for
    logging, by the JAX function's rules: a schedule config gives its value
    at the step (one update a step); a config without ``lr`` logs 1e-3 for
    the repo's factories (their default) and NaN for adafactor (no fixed
    step size) or an unknown target."""
    params = dict(optim_conf.get("params", None) or {})
    lr = params.get("lr", params.get("learning_rate"))
    if lr is None:
        target = str(optim_conf.get("target", ""))
        if "adafactor" not in target.lower() and \
                any(t in target for t in ("torch.optim.", "utils.optim.")):
            return lambda step: 1e-3
        return lambda step: float("nan")
    if isinstance(lr, Mapping):
        return build_schedule(lr)
    return lambda step: float(lr)


def adam(params: Iterable, lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0, mu_dtype=None) -> torch.optim.Optimizer:
    """``mu_dtype="bfloat16"`` stores the first moment in bf16, which halves
    that share of the optimizer's memory (the second moment keeps the
    parameter's dtype)."""
    lr, schedule = _resolve_lr(lr)
    if mu_dtype is not None:
        return scheduled(Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                              mu_dtype=mu_dtype), schedule)
    if weight_decay:
        return scheduled(torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                           weight_decay=weight_decay), schedule)
    return scheduled(torch.optim.Adam(params, lr=lr, betas=betas, eps=eps), schedule)


def adamw(params: Iterable, lr=1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01, mu_dtype=None) -> torch.optim.Optimizer:
    if mu_dtype is not None:
        return adam(params, lr, betas, eps, weight_decay, mu_dtype)
    lr, schedule = _resolve_lr(lr)
    return scheduled(torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                       weight_decay=weight_decay), schedule)


def sgd(params: Iterable, lr, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> torch.optim.Optimizer:
    lr, schedule = _resolve_lr(lr)
    return scheduled(torch.optim.SGD(params, lr=lr, momentum=momentum,
                                     weight_decay=weight_decay, nesterov=nesterov), schedule)


def adafactor(params: Iterable, lr=None, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, momentum: Optional[float] = None,
              momentum_dtype="bfloat16", clipping_threshold: Optional[float] = 1.0,
              multiply_by_parameter_scale: bool = False, weight_decay: float = 0.0,
              eps: float = 1e-30) -> "Adafactor":
    lr, schedule = _resolve_lr(lr)
    return scheduled(Adafactor(params, lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
                               decay_rate=decay_rate, momentum=momentum,
                               momentum_dtype=momentum_dtype,
                               clipping_threshold=clipping_threshold,
                               multiply_by_parameter_scale=multiply_by_parameter_scale,
                               weight_decay=weight_decay, eps=eps), schedule)


@functools.lru_cache(maxsize=256)  # a schedule's lr changes each update
def _scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a Python number that meets an array in JAX
    is weakly typed and takes the array's dtype."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _moment(x: torch.Tensor, acc: torch.Tensor, decay: float) -> torch.Tensor:
    """optax's ``update_moment``, (1 - decay) x + decay acc, as a jitted JAX
    step computes it, in the wider dtype of the two.  Each Python scalar is
    rounded to the dtype of the operand it multiplies (b1 = 0.9 meets a bf16
    moment as 0.8984375); a product in the narrower dtype is not rounded to
    it (XLA drops the f32 -> bf16 -> f32 round trip of a product that the
    sum promotes), one in the wider dtype is."""
    wide = torch.promote_types(x.dtype, acc.dtype)
    out = x.to(wide) * _scalar(1 - decay, x.dtype)
    return out.add_(acc.to(wide) * _scalar(decay, acc.dtype))


class _StateDtypes:
    """``Optimizer.load_state_dict`` casts each floating state tensor to its
    parameter's dtype; this puts back the dtype that ``STATE_DTYPES`` (state
    key -> the param group's dtype option) names."""

    STATE_DTYPES: dict = {}

    def _restore_state_dtypes(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state.get(p)
                for key, option in self.STATE_DTYPES.items():
                    dtype = as_dtype(group.get(option))
                    if state and key in state and dtype is not None:
                        state[key] = state[key].to(dtype)

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        self._restore_state_dtypes()


class Adam(_StateDtypes, torch.optim.Optimizer):
    """Adam as optax computes ``chain(scale_by_adam(b1, b2, eps, mu_dtype),
    add_decayed_weights(weight_decay), scale_by_learning_rate(lr))``, which
    is the JAX ``adam`` with a decay and ``adamw``; the route of ``adam`` /
    ``adamw`` with a ``mu_dtype``.  Per parameter p (gradient g) and update
    n from 1:

    1. mu = (1 - b1) g + b1 mu and nu = (1 - b2) g² + b2 nu;
    2. u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps), the bias
       corrections computed in f32;
    3. mu stored in ``mu_dtype`` (step 2 used it unrounded), nu in the
       parameter's dtype;
    4. p += -lr (u + weight_decay p), rounded once to p's dtype.

    This is what a jitted JAX step computes (``dmtpu.parallel.
    make_train_step``): each operation in the dtype JAX gives its result
    (f32 with f32 parameters whatever ``mu_dtype``; bf16 throughout with
    bf16 parameters and moment, MMDiT's ``param_dtype``), each Python number
    rounded to the dtype of the array it meets (b1 = 0.9 multiplies a bf16
    moment as 0.8984375), and ``_moment``'s products as XLA fuses them.
    """

    STATE_DTYPES = {"exp_avg": "mu_dtype"}

    def __init__(self, params: Iterable, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, mu_dtype=None):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        mu_dtype=as_dtype(mu_dtype))
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
                    state.update(step=0, exp_avg=torch.zeros_like(
                        p, dtype=as_dtype(group["mu_dtype"]) or p.dtype),
                        exp_avg_sq=torch.zeros_like(p))
                p.add_(_adam_update(p, p.grad, state, group))
                state["step"] += 1
        return loss


def _adam_update(p: torch.Tensor, g: torch.Tensor, state: dict, group: dict) -> torch.Tensor:
    """The amount added to p; the moments stored.  Each operation runs in
    the dtype JAX gives its result (mu and the update that of p + mu, nu
    that of p), with its Python scalar rounded to it."""
    b1, b2 = group["betas"]
    n = np.float32(state["step"] + 1)
    mu = _moment(g, state["exp_avg"], b1)
    nu = _moment(g.square(), state["exp_avg_sq"], b2)
    state["exp_avg"].copy_(mu)
    state["exp_avg_sq"].copy_(nu)
    # optax: 1 - decay ** count in f32, then in the moment's dtype
    bc1, bc2 = (float(np.float32(1) - np.float32(b) ** n) for b in (b1, b2))
    u = mu.div_(_scalar(bc1, mu.dtype)).div_(
        nu.div_(_scalar(bc2, nu.dtype)).sqrt_().add_(_scalar(group["eps"], nu.dtype)))
    if group["weight_decay"]:
        u.add_(p.to(u.dtype) * _scalar(group["weight_decay"], p.dtype))
    return u.mul_(_scalar(-group["lr"], u.dtype))


def factored_dims(shape: torch.Size, min_dim_size_to_factor: int) -> Optional[tuple[int, int]]:
    """(second largest dim, largest dim) when the second largest has at least
    ``min_dim_size_to_factor`` entries, else None (optax's ``_factored_dims``)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class Adafactor(_StateDtypes, torch.optim.Optimizer):
    """Adafactor (Shazeer & Stern, arXiv:1804.04235) as ``optax.adafactor``
    computes it; this repo's defaults leave out momentum and parameter
    scaling.  The second-moment statistics are kept in the parameter's
    dtype, as optax keeps them (in a dtype narrower than f32 each is decayed
    and summed in f32 and rounded once, as optax does), and the rest runs in
    the parameter's dtype (bf16 under MMDiT's ``param_dtype``), as optax's
    arithmetic does.  Per parameter and step n (from 0), in optax's chain
    order:

    1. second moment with decay 1 - (n + 1)^-decay_rate of g^2 + eps:
       factored into row and column means over the two largest dims when
       the second largest has >= ``min_dim_size_to_factor`` entries (the
       estimate is symmetric in the two, so OIHW and HWIO kernels agree),
       else kept whole; u = g / sqrt(estimate);
    2. u clipped to block RMS ``clipping_threshold``;
    3. times ``lr`` (none when ``lr`` is None);
    4. with ``multiply_by_parameter_scale``, times max(RMS(param), 1e-3),
       the whole parameter's RMS (a sharded ``DTensor``'s too);
    5. with ``momentum`` m: u = (1 - m) u + m acc (``_moment``: m meets a
       bf16 accumulator as 0.8984375); acc stores u rounded to
       ``momentum_dtype`` (bf16 unless set; None means bf16, as in the JAX
       factory), while u itself goes on unrounded (optax's ``ema`` without
       debiasing);
    6. plus ``weight_decay * param`` (decoupled, not scaled by ``lr``);
    7. param -= u.
    """

    STATE_DTYPES = {"momentum": "momentum_dtype"}

    def __init__(self, params: Iterable, lr: Optional[float] = None,
                 min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
                 momentum: Optional[float] = None, momentum_dtype="bfloat16",
                 clipping_threshold: Optional[float] = 1.0,
                 multiply_by_parameter_scale: bool = False, weight_decay: float = 0.0,
                 eps: float = 1e-30):
        defaults = dict(lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
                        decay_rate=decay_rate, momentum=momentum,
                        momentum_dtype=as_dtype(momentum_dtype) or torch.bfloat16,
                        clipping_threshold=clipping_threshold,
                        multiply_by_parameter_scale=multiply_by_parameter_scale,
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
    state = {"step": 0}
    if group.get("momentum") is not None:
        state["momentum"] = torch.zeros_like(p, dtype=as_dtype(group["momentum_dtype"]))
    dims = factored_dims(p.shape, group["min_dim_size_to_factor"])
    if dims is None:
        return {**state, "v": torch.zeros_like(p)}
    d1, d0 = dims
    return {**state, "v_row": torch.zeros_like(p.mean(d0)), "v_col": torch.zeros_like(p.mean(d1))}


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
    if group.get("multiply_by_parameter_scale"):
        # optax's safe_root_mean_squares(p, 1e-3), in the parameter's dtype
        u.mul_(torch.clamp(p.square().mean().sqrt(), min=_scalar(1e-3, p.dtype)))
    if group.get("momentum") is not None:
        u = _moment(u, state["momentum"], group["momentum"])
        state["momentum"].copy_(u)
    if group["weight_decay"]:
        u.add_(p, alpha=group["weight_decay"])
    return u
