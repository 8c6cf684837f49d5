"""Exponential moving average of parameters.

Counterpart of ``dmtpu/models/ema.py`` (reference: models/ema.py:7-79).  The
JAX state is an immutable pytree replaced each step; here ``update``
changes the shadow in place, which keeps one copy of it on the card.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

# the dtype names a config gives (``dmtpu/utils/optim.py::_dtype``)
_DTYPE_NAMES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                "float32": torch.float32, "f32": torch.float32}


def as_dtype(dtype: Union[torch.dtype, str, None]) -> Optional[torch.dtype]:
    """A ``torch.dtype`` (or None) from itself or its name in a config."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPE_NAMES:
        raise ValueError(f"unknown dtype name {dtype!r}: expected one of {sorted(_DTYPE_NAMES)}")
    return _DTYPE_NAMES[dtype]


class EMAState:
    """Shadow copies of named parameters and the count of updates.

    ``dtype`` (e.g. ``torch.bfloat16``, or its name ``"bfloat16"`` / ``"bf16"``
    as a config gives it) stores the shadow in that dtype,
    which halves its memory for f32 params; per-step increments of relative
    size (1 - decay) |p - s| / |s| below bf16's resolution then round away,
    so a bf16 shadow suits fine-tunes, not long slow-decay averages.
    """

    def __init__(self, shadow: dict[str, torch.Tensor], num_updates: int = 0,
                 decay: float = 0.9999, gradual: bool = True):
        self.shadow = shadow
        self.num_updates = num_updates
        self.decay = decay
        self.gradual = gradual

    @classmethod
    def create(cls, params: Mapping[str, torch.Tensor], decay: float = 0.9999,
               gradual: bool = True, dtype: Union[torch.dtype, str, None] = None
               ) -> "EMAState":
        dtype = as_dtype(dtype)

        def copy(p: torch.Tensor) -> torch.Tensor:
            p = p.detach()
            return p.to(dtype, copy=True) if dtype is not None and p.is_floating_point() \
                else p.clone()

        return cls({name: copy(p) for name, p in params.items()}, 0, decay, gradual)

    def get_decay(self) -> float:
        """min(decay, (1 + n) / (10 + n)) in f32 when ``gradual``
        (reference: models/ema.py:38-42)."""
        if not self.gradual:
            return float(np.float32(self.decay))
        n = np.float32(self.num_updates)
        return float(np.minimum(np.float32(self.decay),
                                (np.float32(1.0) + n) / (np.float32(10.0) + n)))

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor]) -> None:
        """shadow -= (1 - decay) (shadow - param), stored in the shadow's
        dtype: the difference in the wider of the two dtypes (bf16 when both
        are), the rest in f32, as the JAX update's promotions give it;
        ``num_updates`` is incremented before the decay is read (reference:
        models/ema.py:44-52)."""
        self.num_updates += 1
        w = float(np.float32(1.0) - np.float32(self.get_decay()))
        for name, s in self.shadow.items():
            s.copy_(s.float() - w * (s - params[name]).float())
