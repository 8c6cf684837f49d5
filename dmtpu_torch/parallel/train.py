"""The train step: gradient accumulation, clipping, optimizer and EMA.

Counterpart of ``dmtpu/parallel/train.py`` (``TrainState``,
``make_train_step``, ``make_diffusion_loss_fn``; reference:
scripts/train_ddpm.py:171-192), on one card: there is no mesh, and
data-parallel or sharded training (DDP / FSDP) is not ported.  The JAX step
is one pure compiled function of (state, batch, rng); here the state holds
the model, whose parameters the optimizer updates in place, and a step's
randomness is one ``torch.Generator`` seeded from (seed, step), as the JAX
callers fold the step into their key.  Dropout inside the model draws from
the device's default generator, which the step seeds from (seed, step) too
(a stream apart from the loss's generator, as the JAX loss folds a dropout
key out of the step's key) and gives back to the caller as it found it.

A loss function is ``loss_fn(batch, generator) -> scalar loss``; the
diffusion loss draws, in this order, the timesteps, the noise and the
label-dropout mask from the generator, then hands it to the diffuser's
``loss_func`` for any draw of its own (DDPM_IP's perturbation).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch
from torch import nn

from dmtpu_torch.models.ema import EMAState

LossFn = Callable[[Any, torch.Generator], torch.Tensor]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[EMAState] = None
    step: int = 0

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
def dropout_rng(seed: int, step: int, device: torch.device) -> Iterator[None]:
    """Within the block the default generator of ``device`` is seeded from
    (seed, step), on a stream apart from ``step_generator``'s; the caller's
    state is restored afterwards.  Seeding a CUDA generator sets its
    host-side seed and offset: no synchronisation."""
    devices = [_cuda_index(device)] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices, device_type="cuda"):
        default_generator(device).manual_seed(_mixed_seed(seed, step, 1))
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


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all the tensors together, whatever their dtypes, as an
    f32 scalar.  Each tensor's squares are summed in f64: bf16 gradients are
    not rounded to bf16 norms first, and PyTorch's CPU kernel, which sums a
    tensor's squares in f32 one after another, is 1e-4 off at a 512x1024x3x3
    convolution's gradient (the JAX package's f32 tree sums are within
    1e-7)."""
    norms = torch._foreach_norm(tensors, 2.0, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


def make_train_step(loss_fn: LossFn, clip_grad_norm: Optional[float] = None,
                    micro_batches: int = 1, seed: int = 0
                    ) -> Callable[[TrainState, Any], Dict[str, torch.Tensor]]:
    """Build ``step(state, batch) -> {"loss", "grad_norm"}``, which:

    1. averages the loss and the gradients over ``micro_batches`` leading-axis
       splits of the batch (the reference's gradient accumulation);
    2. takes the f32 global norm of the gradients;
    3. scales them by min(1, clip_grad_norm / (norm + 1e-6)) when clipping;
    4. steps the optimizer, then updates the EMA with the new parameters;
    5. advances ``state.step``.

    The loss draws from ``step_generator(seed, step)``, dropout from the
    device's default generator under ``dropout_rng(seed, step)``.

    The metrics stay on the device, so a step does not wait for the card.
    """

    def step_fn(state: TrainState, batch: Any) -> Dict[str, torch.Tensor]:
        params = [p for p in state.model.parameters() if p.requires_grad]
        generator = step_generator(seed, state.step, params[0].device)
        state.optimizer.zero_grad(set_to_none=True)
        parts = _split(batch, micro_batches) if micro_batches > 1 else [batch]
        loss = torch.zeros((), device=params[0].device)
        with dropout_rng(seed, state.step, params[0].device):
            for part in parts:
                part_loss = loss_fn(part, generator)
                (part_loss / len(parts)).backward()
                loss += part_loss.detach()
        loss /= len(parts)
        grad_norm = global_norm([p.grad for p in params if p.grad is not None])
        if clip_grad_norm is not None:
            torch.nn.utils.clip_grads_with_norm_(params, clip_grad_norm, grad_norm)
        state.optimizer.step()
        if state.ema is not None:
            with torch.profiler.record_function("EMAState.update"):
                state.ema.update(dict(state.model.named_parameters()))
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    return step_fn


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
        t = torch.randint(0, total_steps, (b,), generator=generator, device=x0.device)
        eps = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        if p_uncond is not None and cond_key in model_kwargs:
            drop = torch.rand(b, generator=generator, device=x0.device) < p_uncond
            y = model_kwargs[cond_key]
            drop = drop.reshape((b,) + (1,) * (y.dim() - 1))
            model_kwargs[cond_key] = torch.where(drop, torch.full_like(y, null_label), y)
        return diffuser.loss_func(model, x0, t, eps=eps, generator=generator,
                                  model_kwargs=model_kwargs)

    return loss_fn
