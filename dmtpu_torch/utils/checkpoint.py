"""Train-state checkpoints with the reference's directory layout.

Counterpart of ``dmtpu/utils/checkpoint.py``.  The reference writes
``runs/<exp>/ckpt/step{N}/`` (reference: scripts/train_ddpm.py:141-156) and
resumes by best / latest / path (``utils.misc.find_resume_checkpoint``).  Here
each step directory holds one ``torch.save`` file of the ``TrainState``: the
trainable module's ``state_dict``, the optimizer's, the EMA's shadow with
its ``num_updates``, ``decay`` and ``gradual``, and the step.  The JAX package
writes orbax trees instead: the two packages' checkpoints do not read each
other.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Write ``<ckpt_dir>/step{step:06d}/state.pt`` (through a temporary
    file and a rename, so a cut-off save leaves no half file) and return the
    step directory."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step{step:0>6d}")
    os.makedirs(path, exist_ok=True)
    ema = state.ema
    blob = {"step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": None if ema is None else {
                "shadow": ema.shadow, "num_updates": int(ema.num_updates),
                "decay": float(ema.decay), "gradual": bool(ema.gradual)}}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
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
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
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
                s.copy_(shadow[name])
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
