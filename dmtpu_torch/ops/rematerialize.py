"""Gradient checkpointing (rematerialisation) of model blocks.

Counterpart of ``dmtpu/ops/rematerialize.py`` and of ``remat_call`` in
``dmtpu/models/adm.py``.  A model's ``use_checkpoint`` is ``True`` (full
remat: a wrapped block keeps only its inputs and recomputes its forward in
the backward pass) or ``False``.  The JAX package's policy names
(``"dots"``, ``"attn"``, ...), which save chosen intermediates, are not
ported and raise ``NotImplementedError`` naming ROADMAP.md's item H.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint


def normalize_use_checkpoint(use_checkpoint: Any) -> bool:
    """A config's ``use_checkpoint`` as a bool; a policy name raises."""
    if isinstance(use_checkpoint, str):
        raise NotImplementedError(
            f"selective remat policy {use_checkpoint!r} is not ported yet (ROADMAP.md, "
            "Queue 1 item H); use True or False")
    return bool(use_checkpoint)


def remat_call(module: torch.nn.Module, *args: Any, **kwargs: Any) -> Any:
    """``module(*args, **kwargs)``, recomputed in the backward pass instead of
    keeping its intermediates (non-reentrant ``torch.utils.checkpoint``, which
    also replays the RNG state, so dropout draws the same mask)."""
    return checkpoint(module, *args, use_reentrant=False, **kwargs)
