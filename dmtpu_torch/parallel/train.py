"""The train step: gradient accumulation, data parallelism, clipping, the
optimizer and the EMA.

Counterpart of ``dmtpu/parallel/train.py`` (``TrainState``,
``make_train_step``, ``shard_train_state``, ``make_diffusion_loss_fn``;
reference: scripts/train_ddpm.py:171-192).  The JAX step is one pure
compiled function of (state, batch, rng) over a mesh; here the state holds
the model, whose parameters the optimizer updates in place, each rank of the
(data, fsdp) mesh (``parallel/mesh.py``) runs the step on its rows of the
global batch, and a step's randomness is one ``torch.Generator`` seeded from
(seed, step), as the JAX callers fold the step into their key.  Over n
ranks the loss gets it as a ``RowGenerator`` of the rank's rows
(``dmtpu_torch.utils.rows``): each per-row draw is the global batch's draw
at those rows, so a run over n ranks is the one-rank run.
Dropout inside the model draws from the device's default generator, which
the step seeds from (seed, step) too (a stream apart from the loss's
generator, as the JAX loss folds a dropout key out of the step's key; rank
r > 0 on a stream of its own) and gives back to the caller as it found it.

Over a mesh the gradients are averaged over every rank after the
micro-batches and before the clipping.  ``shard_train_state`` with
``fsdp > 1`` shards each parameter by the JAX package's rule
(``mesh.shard_dim``) with FSDP2's ``fully_shard`` over the fsdp dim,
replicated over data (HSDP): the parameters, the optimizer's moments and
the EMA shadow become sharded ``DTensor``s, FSDP2 gathers the parameters
before use and reduce-scatters their gradients; a parameter the rule leaves
replicated stays a plain tensor whose gradient the step all-reduces.

A loss function is ``loss_fn(batch, generator) -> scalar loss`` (over
ranks, ``generator`` is the ``RowGenerator``); the diffusion loss draws, in
this order, the timesteps, the noise and the label-dropout mask from the
generator, then hands it to the diffuser's ``loss_func`` for any draw of
its own (DDPM_IP's perturbation).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from dmtpu_torch.models.ema import EMAState
from dmtpu_torch.parallel.mesh import FSDP_AXIS, mesh_rank, mesh_size, shard_dim
from dmtpu_torch.utils import profiling, rows
from dmtpu_torch.utils.rows import RowGenerator

LossFn = Callable[[Any, torch.Generator], torch.Tensor]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[EMAState] = None
    step: int = 0
    mesh: Optional[DeviceMesh] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               ema_decay: Optional[float] = 0.9999, ema_gradual: bool = True,
               ema_dtype: Union[torch.dtype, str, None] = None) -> "TrainState":
        """``ema_dtype=torch.bfloat16`` (or its name, ``"bfloat16"``) halves
        the EMA shadow's memory (see ``EMAState``); ``ema_decay=None`` keeps
        no EMA."""
        ema = (EMAState.create(dict(model.named_parameters()), ema_decay, ema_gradual, ema_dtype)
               if ema_decay is not None else None)
        return cls(model, optimizer, ema)


def _mixed_seed(*entropy: int) -> int:
    return int(np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0]) >> 1


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The one generator of step ``step``: seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed(_mixed_seed(seed, step))


def _cuda_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def default_generator(device: torch.device) -> torch.Generator:
    """The default generator of ``device``: what ``nn.Dropout`` draws from,
    and what a model's own dropout draws should be handed inside a train
    step, where ``dropout_rng`` seeds it from (seed, step)."""
    if device.type == "cuda":
        return torch.cuda.default_generators[_cuda_index(device)]
    return torch.default_generator


@contextlib.contextmanager
def dropout_rng(seed: int, step: int, device: torch.device, rank: int = 0) -> Iterator[None]:
    """Within the block the default generator of ``device`` is seeded from
    (seed, step), on a stream apart from ``step_generator``'s (and, for
    ``rank`` > 0, apart from the other ranks'); the caller's state is
    restored afterwards.  Seeding a CUDA generator sets its host-side seed
    and offset: no synchronisation."""
    devices = [_cuda_index(device)] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices, device_type="cuda"):
        entropy = (seed, step, 1, rank) if rank else (seed, step, 1)
        default_generator(device).manual_seed(_mixed_seed(*entropy))
        yield


def _split(batch: Any, n: int) -> list:
    """``n`` leading-axis splits of a tensor, or of each tensor of a dict / tuple."""
    if isinstance(batch, torch.Tensor):
        if batch.shape[0] % n:
            raise ValueError(f"batch of {batch.shape[0]} does not split into {n} micro-batches")
        return list(batch.split(batch.shape[0] // n))
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(batch, (tuple, list)):
        return [type(batch)(x) for x in zip(*(_split(v, n) for v in batch))]
    raise TypeError(f"cannot split a batch of type {type(batch).__name__}")


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all the tensors together, whatever their dtypes, as an
    f32 scalar.  Each tensor's squares are summed in f64: bf16 gradients are
    not rounded to bf16 norms first, and PyTorch's CPU kernel, which sums a
    tensor's squares in f32 one after another, is 1e-4 off at a 512x1024x3x3
    convolution's gradient (the JAX package's f32 tree sums are within
    1e-7).  A ``DTensor`` sharded over fsdp adds its shard's squares, summed
    over the fsdp ranks."""
    norms = torch._foreach_norm([_local(t) for t in tensors], 2.0, dtype=torch.float64)
    sharded = [n for n, t in zip(norms, tensors) if isinstance(t, DTensor)]
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(norms)).float()
    squares = torch.stack(sharded).square().sum()
    mesh = next(t for t in tensors if isinstance(t, DTensor)).device_mesh
    dist.all_reduce(squares, group=mesh.get_group(FSDP_AXIS))
    replicated = [n for n, t in zip(norms, tensors) if not isinstance(t, DTensor)]
    if replicated:
        squares = squares + torch.stack(replicated).square().sum()
    return squares.sqrt().float()


def _all_reduce_mean(tensors: list[torch.Tensor]) -> None:
    """Each tensor replaced by its mean over every rank, one all-reduce per
    dtype."""
    n = dist.get_world_size()
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(n)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def _clip(params: list[torch.Tensor], max_norm: float, total_norm: torch.Tensor) -> None:
    """``clip_grads_with_norm_``'s scaling of the parameters' gradients, on
    the local shards of DTensors."""
    grads = [p.grad for p in params if p.grad is not None]
    if not any(isinstance(g, DTensor) for g in grads):
        torch.nn.utils.clip_grads_with_norm_(params, max_norm, total_norm)
        return
    coef = torch.clamp(max_norm / (total_norm + 1e-6), max=1.0)
    for g in grads:
        _local(g).mul_(coef.to(g.device))


def _row_generator(generator: torch.Generator, part: Any, n: int, rank: int) -> Any:
    """``generator`` for this rank's ``k`` rows of a micro-batch: rows
    ``[rank * k, (rank + 1) * k)`` of the draws for its ``n * k``."""
    if n == 1:
        return generator
    lead = part if isinstance(part, torch.Tensor) else next(
        iter(part.values() if isinstance(part, dict) else part))
    k = lead.shape[0]
    return RowGenerator(generator, n * k, torch.arange(rank * k, (rank + 1) * k))


def make_train_step(loss_fn: LossFn, clip_grad_norm: Optional[float] = None,
                    micro_batches: int = 1, seed: int = 0, mesh: Optional[DeviceMesh] = None
                    ) -> Callable[[TrainState, Any], Dict[str, torch.Tensor]]:
    """Build ``step(state, batch) -> {"loss", "grad_norm"}``, which:

    1. averages the loss and the gradients over ``micro_batches`` leading-axis
       splits of the batch (the reference's gradient accumulation): the
       gradients are summed in the parameters' dtype, then divided, in the
       JAX step's order;
    2. over a ``mesh``, averages them over every rank (``batch`` is this
       rank's rows of the global batch, micro-batch by micro-batch:
       ``mesh.shard_batch(..., micro_batches=)``);
    3. takes the f32 global norm of the gradients;
    4. scales them by min(1, clip_grad_norm / (norm + 1e-6)) when clipping;
    5. steps the optimizer, then updates the EMA with the new parameters;
    6. advances ``state.step``.

    The loss draws from ``step_generator(seed, step)``, dropout from the
    device's default generator under ``dropout_rng(seed, step)``.

    The metrics stay on the device, so a step does not wait for the card.
    While a profiler records, the step is a ``train.step`` span with
    ``train.forward`` / ``train.backward`` (each micro-batch), ``train.clip``
    (the division, the all-reduce, the norm and the clip), ``train.optimizer``
    and ``train.ema`` under it (``utils/profiling.py``).
    """
    n, rank = mesh_size(mesh), mesh_rank(mesh)

    @profiling.spanned("train.step", device=True)
    def step_fn(state: TrainState, batch: Any) -> Dict[str, torch.Tensor]:
        params = [p for p in state.model.parameters() if p.requires_grad]
        device = _local(params[0]).device
        generator = step_generator(seed, state.step, device)
        state.optimizer.zero_grad(set_to_none=True)
        parts = _split(batch, micro_batches) if micro_batches > 1 else [batch]
        loss = torch.zeros((), device=device)
        with dropout_rng(seed, state.step, device, rank):
            for part in parts:
                with profiling.span("train.forward"):
                    part_loss = loss_fn(part, _row_generator(generator, part, n, rank))
                with profiling.span("train.backward"):
                    part_loss.backward()
                loss += part_loss.detach()
        with profiling.span("train.clip"):
            loss /= len(parts)
            grads = [p.grad for p in params if p.grad is not None]
            if len(parts) > 1:  # the sum in the parameters' dtype, then the mean, as JAX
                torch._foreach_div_([_local(g) for g in grads], float(len(parts)))
            if n > 1:  # FSDP2 has reduced the sharded parameters' gradients
                _all_reduce_mean([g for g in grads if not isinstance(g, DTensor)] + [loss])
            grad_norm = global_norm(grads)
            if clip_grad_norm is not None:
                _clip(params, clip_grad_norm, grad_norm)
        with profiling.span("train.optimizer"):
            state.optimizer.step()
        if state.ema is not None:
            with profiling.span("train.ema"):
                state.ema.update(dict(state.model.named_parameters()))
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    return step_fn


def shard_train_state(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """Place ``state`` on ``mesh`` (before its first step or load).  With
    fsdp = 1 the parameters stay replicated; with fsdp > 1 each parameter
    that ``mesh.shard_dim`` shards is sharded over fsdp (FSDP2
    ``fully_shard``, replicated over data), the optimizer takes the sharded
    parameters (its moments are made sharded at its first step) and the EMA
    shadow is sharded as its parameter."""
    state.mesh = mesh
    fsdp = mesh_size(mesh, FSDP_AXIS)
    if fsdp == 1:
        return state
    from torch.distributed.fsdp import fully_shard

    model = state.model
    names = {id(p): name for name, p in model.named_parameters()}
    dims = {id(p): shard_dim(tuple(p.shape), fsdp) for p in model.parameters()}
    ignored = {p for p in model.parameters() if dims[id(p)] is None}
    if len(ignored) == len(dims):
        return state
    fully_shard(model, mesh=mesh, shard_placement_fn=lambda p: Shard(dims[id(p)]),
                ignored_params=ignored or None)
    new = dict(model.named_parameters())
    for group in state.optimizer.param_groups:
        group["params"] = [new[names[id(p)]] for p in group["params"]]
    state.optimizer.state.clear()
    if state.ema is not None:
        for name, shadow in state.ema.shadow.items():
            p = new.get(name)
            if isinstance(p, DTensor):
                state.ema.shadow[name] = distribute_tensor(shadow, p.device_mesh, p.placements)
    return state


def make_diffusion_loss_fn(diffuser, model: Callable[..., torch.Tensor], total_steps: int,
                           p_uncond: Optional[float] = None, null_label: Optional[int] = None,
                           cond_key: str = "y") -> LossFn:
    """The standard diffusion loss: random t, optional label dropout, MSE.

    ``batch`` is a dict (``"image"`` and model kwargs), an (image, label)
    pair, or an image tensor.  ``p_uncond`` / ``null_label`` drop each
    sample's label with probability ``p_uncond`` (classifier-free guidance
    training; reference: scripts/train_ddpm_cfg.py:180-181).  The step's
    generator goes on to ``diffuser.loss_func``, which draws from it what
    else it needs (DDPM_IP's ``perturb_eps``, after t, eps and the mask);
    DDPM, DDPMCFG and flow matching draw nothing there.
    """

    def loss_fn(batch: Any, generator: torch.Generator) -> torch.Tensor:
        if isinstance(batch, dict):
            x0 = batch["image"]
            model_kwargs = {k: v for k, v in batch.items() if k != "image"}
        elif isinstance(batch, (tuple, list)):
            x0, y = batch
            model_kwargs = {cond_key: y}
        else:
            x0, model_kwargs = batch, {}
        b = x0.shape[0]
        t = rows.randint(0, total_steps, (b,), generator, x0.device)
        eps = rows.randn(x0.shape, generator, x0.device, x0.dtype)
        if p_uncond is not None and cond_key in model_kwargs:
            drop = rows.rand(b, generator, x0.device) < p_uncond
            y = model_kwargs[cond_key]
            drop = drop.reshape((b,) + (1,) * (y.dim() - 1))
            model_kwargs[cond_key] = torch.where(drop, torch.full_like(y, null_label), y)
        return diffuser.loss_func(model, x0, t, eps=eps, generator=generator,
                                  model_kwargs=model_kwargs)

    return loss_fn
