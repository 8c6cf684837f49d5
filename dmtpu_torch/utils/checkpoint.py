"""Train-state checkpoints with the reference's directory layout.

Counterpart of ``dmtpu/utils/checkpoint.py``.  The reference writes
``runs/<exp>/ckpt/step{N}/`` (reference: scripts/train_ddpm.py:141-156) and
resumes by best / latest / path (``utils.misc.find_resume_checkpoint``).  Here
each step directory holds one ``torch.save`` file of the ``TrainState``: the
trainable module's ``state_dict``, the optimizer's, the EMA's shadow with
its ``num_updates``, ``decay`` and ``gradual``, and the step.  The JAX package
writes orbax trees instead: the two packages' checkpoints do not read each
other.

A train state sharded over ranks (``parallel.shard_train_state``) is saved
in the same one-card format: every rank gathers the full tensors of its
sharded ``DTensor``s (a collective, so every rank calls ``save_checkpoint``)
and rank 0 writes the file.  Loading reads the full file on every rank and
shards each tensor as the state's own is sharded.

``save_array_dict`` writes a flat ``.npz`` of tensors or arrays, as the JAX
function of that name does (portable model-only weights).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

STATE_FILE = "state.pt"


def _full(tree: Any) -> Any:
    """``tree`` with each ``DTensor`` gathered to its full tensor."""
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_full(v) for v in tree]
    return tree


def _like(value: torch.Tensor, current: Any) -> torch.Tensor:
    """A full loaded tensor placed as ``current`` is (sharded when it is a
    ``DTensor``)."""
    if isinstance(current, DTensor) and not isinstance(value, DTensor):
        return distribute_tensor(value.to(current.dtype), current.device_mesh, current.placements)
    return value


def _optimizer_state_like(blob: Dict[str, Any], optimizer) -> Dict[str, Any]:
    """A loaded optimizer state dict with each tensor of a parameter's shape
    sharded as that (sharded) parameter."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state = {i: {k: _like(v, params[i]) if torch.is_tensor(v) and v.shape == params[i].shape
                 else v for k, v in entry.items()}
             for i, entry in blob["state"].items()}
    return {**blob, "state": state}


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Write ``<ckpt_dir>/step{step:06d}/state.pt`` (through a temporary
    file and a rename, so a cut-off save leaves no half file) and return the
    step directory."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step{step:0>6d}")
    ema = state.ema
    blob = {"step": int(state.step),
            "model": _full(state.model.state_dict()),
            "optimizer": _full(state.optimizer.state_dict()),
            "ema": None if ema is None else {
                "shadow": _full(ema.shadow), "num_updates": int(ema.num_updates),
                "decay": float(ema.decay), "gradual": bool(ema.gradual)}}
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(blob, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
    if dist.is_initialized():
        dist.barrier()
    return path


def _load(path: str, device: Any) -> Dict[str, Any]:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location=device,
                      weights_only=True)


def load_checkpoint(path: str, state):
    """Restore the checkpoint at ``path`` into ``state`` in place, onto the
    device of its parameters, and return ``state``.  The module and the EMA
    must have the checkpoint's keys; the EMA shadow keeps its dtype."""
    device = next(state.model.parameters()).device
    blob = _load(path, device)
    current = state.model.state_dict()
    state.model.load_state_dict({k: _like(v, current.get(k)) for k, v in blob["model"].items()})
    state.optimizer.load_state_dict(_optimizer_state_like(blob["optimizer"], state.optimizer))
    if (blob["ema"] is None) != (state.ema is None):
        raise ValueError(f"{path}: the checkpoint and the train state disagree on keeping "
                         "an EMA")
    if state.ema is not None:
        shadow = blob["ema"]["shadow"]
        if shadow.keys() != state.ema.shadow.keys():
            raise ValueError(f"{path}: the checkpoint's EMA shadow has other keys than the "
                             "train state's")
        with torch.no_grad():
            for name, s in state.ema.shadow.items():
                s.copy_(_like(shadow[name], s))
        state.ema.num_updates = blob["ema"]["num_updates"]
        state.ema.decay = blob["ema"]["decay"]
        state.ema.gradual = blob["ema"]["gradual"]
    state.step = blob["step"]
    return state


def load_checkpoint_host(path: str) -> Dict[str, Any]:
    """The checkpoint at ``path`` as a dict of CPU tensors (``step``,
    ``model``, ``optimizer``, ``ema``), whatever device it was saved from:
    for offline tools such as ``merge_lora``."""
    return _load(path, "cpu")


def save_array_dict(path: str, arrays: Dict[str, Any]) -> None:
    """A flat ``.npz`` of ``arrays`` (tensors, moved to the host, or
    arrays).  numpy has no bf16: a bf16 tensor is written as f32, which
    holds it exactly."""
    def host(v: Any) -> np.ndarray:
        if not torch.is_tensor(v):
            return np.asarray(v)
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()

    np.savez(path, **{k: host(v) for k, v in arrays.items()})
