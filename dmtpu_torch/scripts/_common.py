"""Helpers shared by the sampling CLIs.

Counterpart of ``scripts/_common.py``: ``base_parser``, ``load_conf``,
``diffusion_params``, ``image_shape`` and the ``.npz`` and torch-file
branches of ``load_model_params``, with ``load_torch_weights`` (the JAX
package's ``dmtpu.convert.load_torch_weights``) beside them.  The orbax
train-state directory of the JAX loader has no counterpart (the port's
checkpoints are torch files), and the data-parallel sampler is not ported:
one device.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dmtpu_torch.utils.config import Config, load_config, merge_dotlist


def base_parser(description: Optional[str] = None) -> argparse.ArgumentParser:
    """The flags every sampling CLI takes, plus ``--device``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-c", "--config", type=str, required=True)
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--respace_type", type=str, default="uniform")
    p.add_argument("--respace_steps", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def load_conf(args: argparse.Namespace, unknown: Sequence[str]) -> Config:
    """The config file with ``key=value`` overrides merged over it.

    ``--key=value`` is taken too (the dashes are stripped); anything else
    among the unknown arguments is a mistyped flag and aborts rather than
    being dropped."""
    overrides, bad = [], []
    for a in unknown:
        if "=" in a:
            overrides.append(a.lstrip("-"))
        else:
            bad.append(a)
    if bad:
        raise SystemExit(f"unrecognized arguments: {bad} (config overrides must be key=value)")
    return merge_dotlist(load_config(args.config), overrides)


def diffusion_params(args: argparse.Namespace, conf: Mapping, **extra: Any) -> Dict[str, Any]:
    """The sampler's constructor arguments: the config's
    ``diffusion.params``, the CLI's respacing when ``--respace_steps`` is
    given, then ``extra``; the reference's ``device`` key is dropped."""
    params = dict(conf["diffusion"].get("params", None) or {})
    if args.respace_steps is not None:
        params.update(respace_type=args.respace_type, respace_steps=args.respace_steps)
    params.pop("device", None)
    params.update(extra)
    return params


def image_shape(conf: Mapping) -> Tuple[int, int, int]:
    """(C, H, W) of the config's images (NCHW; the JAX helper gives HWC)."""
    s = conf["data"]["params"]["img_size"]
    return (conf["data"].get("img_channels", 3), s, s)


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file as a flat state dict: ``.safetensors``, or a torch
    file holding the state dict itself or under ``state_dict``,
    ``ema.shadow`` or ``model`` (reference: utils/load.py:7-19)."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError("loading a .safetensors file needs the `safetensors` package") from e
        return dict(load_file(path))
    weights = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in weights:
        weights = weights["state_dict"]
    elif "ema" in weights:
        weights = weights["ema"]["shadow"]
    elif "model" in weights:
        weights = weights["model"]
    return {k: torch.as_tensor(v) for k, v in weights.items()}


def load_npz_params(path: str) -> Dict[str, Any]:
    """The params tree of a JAX-package ``.npz`` export (``params`` as a
    pickled object array: the JAX package's own file, read as it reads it)."""
    with np.load(path, allow_pickle=True) as data:
        return data["params"].item()


def load_model_params(path: str, model: nn.Module) -> nn.Module:
    """``model`` with the weights of ``path`` loaded: a JAX-package ``.npz``
    export (through the Flax bridge) or a torch file in ``model``'s keys.
    Returns the model."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: the JAX package's orbax train states are not read here; "
            "give a .npz export or a torch file")
    if path.endswith(".npz"):
        from dmtpu_torch.convert import load_flax_params

        return load_flax_params(model, load_npz_params(path))
    model.load_state_dict(load_torch_weights(path))
    return model
