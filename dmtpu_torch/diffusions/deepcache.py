"""DeepCache serving loops: sampling with a cached UNet.

Counterpart of ``dmtpu/diffusions/deepcache.py`` (Ma et al., "DeepCache:
Accelerating Diffusion Models for Free", 2023).  Deep UNet features drift
slowly between adjacent sampler steps.  ``SDUNetModel`` has full and shallow
passes (``dc_skip`` / ``dc_cached``); these loops alternate them: the full
UNet every ``interval``-th model call, the shallow slice (the outermost
``dc_skip`` skip levels around the cached deep feature) in between.  The
choice is made on the host from the call's index.

``interval=1`` reproduces the diffuser's own sampler: ``deepcache_sample``
draws from ``generator`` in the order of ``DDPM.sample_loop`` (the step's
``denoise_step``, then its ``apply_guidance``), so this holds for the
stochastic and the guided samplers too.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Tensor = torch.Tensor
FullFn = Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]
ShallowFn = Callable[[Tensor, Tensor, Tensor], Tensor]
Seam = Callable[[Tensor, Tensor, Dict[str, float]], Tensor]


def _check_interval(interval: int) -> None:
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")


def _t_batch(x: Tensor, t: int) -> Tensor:
    return torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)


def deepcache_sample(diffuser, full_fn: FullFn, shallow_fn: ShallowFn, init_noise: Tensor,
                     generator: Optional[torch.Generator] = None, interval: int = 2,
                     postprocess: Optional[Seam] = None) -> Tensor:
    """Run the diffuser's reverse tape with DeepCache model dispatch.

    ``full_fn(x, t_batch) -> (model_out, cache)``;
    ``shallow_fn(x, t_batch, cache) -> model_out`` (they close over the
    conditioning).  Step 0 runs full (there is no cache yet); afterwards
    every ``interval``-th step refreshes the cache and the rest reuse it.
    ``diffuser`` gives the step math through its tape, ``denoise_step`` and
    ``apply_guidance`` (DDPM, DDIM and the guidance classes have that seam).

    ``postprocess(model_out, x, c) -> model_out`` runs before the denoise step
    with the tape row ``c`` in hand: the CFG seam, where a doubled-batch
    output is split, each half ``predict``-ed and the two combined into the
    guided eps, as ``DDPMCFG`` does.
    """
    _check_interval(interval)
    rows = diffuser.tape_rows(diffuser.sampler_tape())
    x = init_noise.float()
    cache = None
    for i, c in enumerate(rows):
        t = _t_batch(x, c["t"])
        if i % interval == 0:
            out, cache = full_fn(x, t)
        else:
            out = shallow_fn(x, t, cache)
        if postprocess is not None:
            out = postprocess(out, x, c)
        step = diffuser.denoise_step(out, x, c, generator)
        x = diffuser.apply_guidance(step, x, c, generator)["sample"]
    return x


def pfdiff_deepcache_sample(diffuser, full_fn: FullFn, shallow_fn: ShallowFn,
                            init_noise: Tensor, interval: int = 2,
                            eps_fn: Optional[Seam] = None) -> Tensor:
    """PFDiff-1's grid traversal with DeepCache model dispatch.

    ``diffuser`` is a ``PFDiffDDIM`` (deterministic, so no generator);
    ``full_fn`` and ``shallow_fn`` as in ``deepcache_sample``.  Model call 0
    (the PFDiff anchor) runs full; call k runs full when k % interval == 0.
    ``eps_fn(model_out, x, c) -> eps`` replaces the default
    ``diffuser.predict(...)["pred_eps"]``: the CFG seam, as in
    ``PFDiffDDIMCFG._eps_at``.
    """
    _check_interval(interval)
    anchor, spring, mid, full, trail = diffuser.pfdiff_tapes()
    x = init_noise.float()

    def eps_from(out, xc, c):
        if eps_fn is not None:
            return eps_fn(out, xc, c)
        return diffuser.predict(out, xc, c)["pred_eps"]

    c0 = diffuser.tape_rows(anchor)[0]
    out, cache = full_fn(x, _t_batch(x, c0["t"]))
    eps = eps_from(out, x, c0)
    x, _ = diffuser._jump_with_eps(eps, x, c0)

    calls = 1
    if spring is not None:
        for cs, cm, cf in zip(*(diffuser.tape_rows(t) for t in (spring, mid, full))):
            x_spring, _ = diffuser._jump_with_eps(eps, x, cs)
            t = _t_batch(x, cm["t"])
            if calls % interval == 0:
                out, cache = full_fn(x_spring, t)
            else:
                out = shallow_fn(x_spring, t, cache)
            eps = eps_from(out, x_spring, cm)
            x, _ = diffuser._jump_with_eps(eps, x, cf)
            calls += 1
    if trail is not None:
        ct = diffuser.tape_rows(trail)[0]
        t = _t_batch(x, ct["t"])
        if calls % interval == 0:
            out, cache = full_fn(x, t)
        else:
            out = shallow_fn(x, t, cache)
        x, _ = diffuser._jump_with_eps(eps_from(out, x, ct), x, ct)
    return x
