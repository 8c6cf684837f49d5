"""Gradient checkpointing (rematerialisation) of model blocks, with policies.

Counterpart of ``dmtpu/ops/rematerialize.py`` and of ``remat_call`` in
``dmtpu/models/adm.py``.  A model's ``use_checkpoint`` is ``True`` (full
remat: a wrapped block keeps only its inputs and recomputes its forward in
the backward pass), ``False``, or one of the JAX package's policy names,
which keep chosen intermediates and recompute the rest
(``normalize_use_checkpoint``).

Each JAX policy (``jax/_src/ad_checkpoint.py``) is carried over as the ATen
operators whose outputs it keeps, through
``torch.utils.checkpoint.create_selective_checkpoint_contexts`` (a selective
checkpoint sees the operators the dispatcher sees; ``nn.Linear`` reaches it
as ``mm`` / ``addmm``, ``einsum`` and ``matmul`` over batches as ``bmm``):

- ``dots`` / ``dots_saveable`` (``dots_saveable``: ``dot_general``,
  ``conv_general_dilated`` and ``scaled_matmul_wrapper``): ``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``convolution`` and ``_scaled_mm``;
- ``dots_no_batch`` (``dots_with_no_batch_dims_saveable``: a
  ``dot_general`` without batch dimensions, a scaled matmul of batch 1):
  ``mm``, ``addmm`` and ``_scaled_mm``, the products of a layer's weight;
  the batched products of attention and the convolutions are recomputed;
- ``attn`` (``save_only_these_names("attn_out")``): the attention operator
  ``torch.ops.dmtpu.attention`` (``dmtpu_torch.ops.attention``), whose
  outputs (O and the lse K2 reads) are what the JAX modules tag
  ``attn_out``, so the recompute never launches K1 again.  The JAX package
  tags the SD ``CrossAttention`` and the pixel UNet's ``SelfAttentionBlock``;
  here every attention a model runs is that operator, so the other families'
  attention is kept too (their numbers do not change, only what is stored);
- ``nothing`` (``nothing_saveable``): full remat, which is plain
  ``checkpoint`` (a selective checkpoint that keeps nothing computes the
  same and intercepts every operator on the host);
- ``everything`` (``everything_saveable``: "no remat"): the block runs
  without a checkpoint.  A selective checkpoint keeping every operator
  would still run the block's Python again in the backward pass and
  relaunch what the dispatcher does not see (K3, a ctypes launch).

``remat_call`` recomputes through ``torch.func.functional_call`` with the
tensors the module held at forward time when they are not its own
parameters, so a block run inside ``functional_call`` (LoRA's merged
weights, an EMA preview) is recomputed with the same weights.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

import dmtpu_torch.ops.attention  # noqa: F401  (registers torch.ops.dmtpu.attention)

POLICIES = {
    "dots": "dots_saveable",
    "dots_saveable": "dots_saveable",
    "dots_no_batch": "dots_with_no_batch_dims_saveable",
    "nothing": "nothing_saveable",
    "everything": "everything_saveable",
}

# named-tensor policies: save only what the JAX modules tag with these names
NAMED_POLICIES = {
    "attn": ("attn_out",),
}

_aten = torch.ops.aten
_NO_BATCH_DOTS = (_aten.mm, _aten.addmm, _aten._scaled_mm)
_SAVED_OPS = {
    "dots_saveable": _NO_BATCH_DOTS + (_aten.bmm, _aten.baddbmm, _aten.convolution),
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
}


class Policy:
    """A JAX checkpoint policy: ``name`` (the ``jax.checkpoint_policies``
    function) and the operators whose outputs it keeps (``saves``; None
    keeps every output: no remat).  Called as a selective checkpoint's
    ``policy_fn``."""

    def __init__(self, name: str, saves: Optional[Tuple[Any, ...]]):
        self.name, self.saves = name, saves

    def __call__(self, ctx, func, *args, **kwargs) -> CheckpointPolicy:
        if func.overloadpacket in self.saves:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def context_fn(self) -> Optional[Callable]:
        """The ``checkpoint(..., context_fn=)`` of this policy (None: plain
        checkpoint, for a policy that keeps nothing)."""
        if not self.saves:
            return None
        return functools.partial(create_selective_checkpoint_contexts, self)


def checkpoint_policy(name: Optional[str]) -> Optional[Policy]:
    """Resolve a policy name to a ``Policy`` (None -> None: full remat, the
    default); an unknown name raises ``ValueError``."""
    if name is None:
        return None
    if name in NAMED_POLICIES:
        return Policy(f"save_only_these_names{NAMED_POLICIES[name]}",
                      (torch.ops.dmtpu.attention,))
    if name not in POLICIES:
        raise ValueError(f"unknown checkpoint policy {name!r}; options: "
                         f"{sorted(POLICIES) + sorted(NAMED_POLICIES)}")
    jax_name = POLICIES[name]
    saves = None if jax_name == "everything_saveable" else _SAVED_OPS.get(jax_name, ())
    return Policy(jax_name, saves)


def normalize_use_checkpoint(use_checkpoint: Any) -> Tuple[bool, Optional[Policy]]:
    """Split a config's ``use_checkpoint`` into (enabled, policy): True /
    False keep full / no remat; a string enables remat under that policy."""
    if isinstance(use_checkpoint, str):
        return True, checkpoint_policy(use_checkpoint)
    return bool(use_checkpoint), None


def _held_tensors(module: torch.nn.Module) -> Optional[dict]:
    """The module's parameters and buffers by name when some parameter is
    not its own ``nn.Parameter`` (the module runs inside
    ``functional_call``), else None."""
    params = dict(module.named_parameters())
    if all(isinstance(p, torch.nn.Parameter) for p in params.values()):
        return None
    return {**params, **dict(module.named_buffers())}


def remat_call(module: torch.nn.Module, *args: Any, policy: Optional[Policy] = None,
               **kwargs: Any) -> Any:
    """``module(*args, **kwargs)``, recomputed in the backward pass instead of
    keeping its intermediates, but for what ``policy`` keeps
    (non-reentrant ``torch.utils.checkpoint``, which also replays the RNG
    state, so dropout draws the same mask)."""
    if policy is not None and policy.saves is None:
        return module(*args, **kwargs)
    held = _held_tensors(module)
    fn = module if held is None else (
        lambda *a, **kw: torch.func.functional_call(module, held, a, kw))
    context_fn = policy.context_fn() if policy is not None else None
    if context_fn is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)
