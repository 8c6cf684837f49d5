"""Operations of a forward pass, and the calls it makes to each kernel,
counted from the shapes that the reference model sees.

``count(model, *inputs)`` runs ``model`` once on the meta device (no memory,
no arithmetic) with forward hooks and returns a ``Count``:

- ``flops``: two operations a multiply-add of every linear layer and
  convolution at the rows it is given, and each attention's Q K^T and P V,
  4 S_q S_k D over all heads (self-, cross-, causal, the DiT blocks' and the
  VAE's single wide head alike: the products are computed whole).
  Elementwise work is not counted.
- ``attention``: the (batch, heads, S_q, S_k, head dim) of each attention
  call, in order, with the name of the module that made it;
- ``group_norm``: the (batch, channels, H*W, silu) of each GroupNorm call,
  with its module name.

This completes the program's own counter (``chip_smoke.forward_flops``), which
misses DiT's attention and the VAE's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
from torch import nn

from portbench.reference.nn import Attend, Conv2d, GroupNorm, Linear


@dataclasses.dataclass
class Count:
    flops: int = 0
    attention: List[Tuple[str, Tuple[int, int, int, int, int]]] = dataclasses.field(
        default_factory=list)
    group_norm: List[Tuple[str, Tuple[int, int, int, bool]]] = dataclasses.field(
        default_factory=list)


def _meta(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, (tuple, list)):
        return type(x)(_meta(v) for v in x)
    return x


def count(model: nn.Module, *inputs: Any, method: str = "forward") -> Count:
    """The operations and kernel calls of ``getattr(model, method)(*inputs)``;
    ``model`` is moved to the meta device (build it there)."""
    model = model.to("meta")
    out = Count()
    names = {m: n for n, m in model.named_modules()}

    def linear(m, args, res):
        out.flops += 2 * res.numel() * m.in_features

    def conv(m, args, res):
        k = m.kernel_size[0] * m.kernel_size[1]
        out.flops += 2 * res.numel() * (m.in_channels // m.groups) * k

    def attend(m, args, kwargs, res):
        q, k = args[0], args[1]
        b, sq, h, d = q.shape
        out.flops += 4 * b * h * sq * k.shape[1] * d
        out.attention.append((names[m], (b, h, sq, k.shape[1], d)))

    def norm(m, args, kwargs, res):
        x = args[0]
        hw = x[0, 0].numel()
        out.group_norm.append((names[m], (x.shape[0], x.shape[1], hw,
                                          bool(kwargs.get("silu", False)))))

    hooks = []
    for m in model.modules():
        if isinstance(m, Linear):
            hooks.append(m.register_forward_hook(linear))
        elif isinstance(m, Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, Attend):
            hooks.append(m.register_forward_hook(attend, with_kwargs=True))
        elif isinstance(m, GroupNorm):
            hooks.append(m.register_forward_hook(norm, with_kwargs=True))
    try:
        with torch.no_grad():
            getattr(model, method)(*_meta(inputs))
    finally:
        for hook in hooks:
            hook.remove()
    return out
