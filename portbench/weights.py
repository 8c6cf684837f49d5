"""Seeded random weights, made on the device in one draw.

Both sides get the same tensors from the same seed: the program under test
loads them into its modules, the reference into its own.  Weights of two or
more dims (linear, convolution, embedding) are N(0, 1/fan_in), fan_in being
the entries of one output row; one-dim weights (norm scales) are 1 + N(0,
0.05^2) and biases N(0, 0.02^2).  Every layer is drawn, none left at zero,
so that every path of the model carries signal and every leaf a gradient.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch


def shapes_of(module: torch.nn.Module) -> Dict[str, torch.Size]:
    """Name -> shape of each entry of ``module``'s state dict (build it on
    the meta device: nothing is allocated)."""
    return {k: v.shape for k, v in module.state_dict().items()}


def make(shapes: Mapping[str, torch.Size], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 tensors of ``shapes``, views of one buffer drawn from ``seed``
    on ``device``."""
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        w = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            w.mul_(float(n // shape[0]) ** -0.5)
        elif name.endswith("bias"):
            w.mul_(0.02)
        else:
            w.mul_(0.05).add_(1.0)
        out[name] = w
    return out


def reference_model(build, seed: int, device: torch.device) -> torch.nn.Module:
    """``build()``'s module on ``device`` holding the weights of ``seed``: built
    on the meta device, then given storage and loaded, with nothing drawn
    twice."""
    with torch.device("meta"):
        module = build()
    shapes = shapes_of(module)
    module = module.to_empty(device=device)
    module.load_state_dict(make(shapes, seed, device))
    return module
