"""LoRA (low-rank adaptation) for fine-tuning, without module surgery.

Counterpart of ``dmtpu/models/lora.py``.  The base model stays as it is,
frozen; the adapters live in a module of their own (``LoRA``), so that the
train state, its optimizer, its EMA and its checkpoint see only them.  A
forward runs the base through ``torch.func.functional_call`` with the
merged weights ``W + scale · (a @ b)ᵀ`` of the adapted layers
(``lora_weights``), built anew in each forward, as the JAX package's
``apply_lora`` does inside its compiled step.

Adapters are keyed by the module path of the ``nn.Linear`` they adapt
(``input_blocks.1.1.transformer_blocks.0.attn1.to_q``); ``a`` is
[d_in, rank] and ``b`` [rank, d_out], the JAX package's orientation, so the
arrays of one carry over to the other unchanged.  A flat mapping of adapter
tensors (``LoRA.state_dict()``, its EMA shadow, a checkpoint's ``model``) has
the keys ``<path>.a`` and ``<path>.b``.

The UNet's ``use_checkpoint`` composes with this: ``remat_call``
(``dmtpu_torch/ops/rematerialize.py``) holds the tensors a block ran with
inside ``functional_call``, the merged weights, and recomputes the block
with them in the backward pass, after ``functional_call`` has put the base
weights back.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

# every attention projection (self and cross) of the UNet's SpatialTransformers;
# the Flax module name ``to_out__0`` is the torch path ``to_out.0``
DEFAULT_TARGETS: Tuple[str, ...] = ("to_q", "to_k", "to_v", "to_out__0")


def lora_scale(rank: int, alpha: Optional[float] = None) -> float:
    """The merge scale alpha / rank (alpha defaults to rank: scale 1)."""
    return float(rank if alpha is None else alpha) / float(rank)


def _is_target(path: str, module: nn.Module, targets: Sequence[str]) -> bool:
    names = [t.replace("__", ".") for t in targets]
    return isinstance(module, nn.Linear) and any(
        path == n or path.endswith("." + n) for n in names)


class LoRA(nn.Module):
    """The adapters of one base module: for each adapted ``nn.Linear`` at
    ``path``, the parameters ``<path>.a`` [d_in, rank] and ``<path>.b``
    [rank, d_out], held in a tree of containers that mirrors the base's."""

    def __init__(self, shapes: Mapping[str, Tuple[int, int]], rank: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.rank = rank
        self.paths = list(shapes)
        for path, (d_in, d_out) in shapes.items():
            node = self
            for part in path.split("."):
                if part not in node._modules:
                    node.add_module(part, nn.Module())
                node = node._modules[part]
            node.a = nn.Parameter(torch.zeros(d_in, rank, dtype=dtype, device=device))
            node.b = nn.Parameter(torch.zeros(rank, d_out, dtype=dtype, device=device))


def init_lora(module: nn.Module, generator: Optional[torch.Generator] = None, rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS, dtype: torch.dtype = torch.float32
              ) -> LoRA:
    """The adapters of every ``nn.Linear`` of ``module`` whose path ends in
    one of ``targets`` (``to_out__0`` and ``to_out.0`` name the same layer),
    on its device.  ``a`` is N(0, 1) / rank from ``generator`` and ``b`` is
    zero, so the adapted model starts exactly at the base model."""
    shapes = {path: (m.in_features, m.out_features) for path, m in module.named_modules()
              if _is_target(path, m, targets)}
    if not shapes:
        raise ValueError(f"no LoRA targets {tuple(targets)} found in the module")
    device = next(module.parameters()).device
    lora = LoRA(shapes, rank, dtype, device)
    with torch.no_grad():
        for path in lora.paths:
            a = lora.get_parameter(path + ".a")
            a.copy_(torch.randn(a.shape, generator=generator, device=device, dtype=dtype) / rank)
    return lora


def _pairs(lora: Mapping[str, torch.Tensor]) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    paths = sorted({k.rpartition(".")[0] for k in lora})
    return {p: (lora[p + ".a"], lora[p + ".b"]) for p in paths}


def lora_weights(params: Mapping[str, torch.Tensor], lora: Mapping[str, torch.Tensor],
                 scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """``{<path>.weight: W + scale · (a @ b)ᵀ}`` for every adapter in
    ``lora`` (a flat ``<path>.a`` / ``<path>.b`` mapping), in W's dtype: what
    ``functional_call`` takes to run the base as the adapted model.  An
    adapter whose layer is not in ``params`` raises."""
    missing = [p for p in _pairs(lora) if p + ".weight" not in params]
    if missing:
        raise ValueError(f"LoRA keys not in params: {missing[:3]}...")
    out = {}
    for path, (a, b) in _pairs(lora).items():
        w = params[path + ".weight"]
        out[path + ".weight"] = w + (scale * (a @ b)).t().to(w.dtype)
    return out


def apply_lora(params: Mapping[str, torch.Tensor], lora: Mapping[str, torch.Tensor],
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """``params`` (a flat state dict) with ``W + scale · (a @ b)ᵀ`` at every
    adapted layer; differentiable with respect to the adapters."""
    return {**params, **lora_weights(params, lora, scale)}


merge_lora = apply_lora  # merge once, save, serve the merged weights


def lora_param_count(lora: Mapping[str, torch.Tensor]) -> int:
    return sum(int(v.numel()) for v in lora.values())
