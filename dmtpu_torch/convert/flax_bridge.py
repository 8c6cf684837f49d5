"""JAX-package params -> torch ``state_dict``.

The JAX package names its Flax submodules after the upstream torch module
paths with ``.`` written as ``__`` (``dmtpu/convert/common.py:3-13``), and
converts torch tensors onto Flax leaves by fixed rules
(``dmtpu/convert/common.py:109-127``).  This module inverts those rules:

  a__b                   -> a.b
  kernel (4-D, HWIO)     -> weight, transposed to OIHW (3, 2, 0, 1)
  kernel (2-D, in x out) -> weight, transposed
  scale                  -> weight  (GroupNorm, LayerNorm)
  embedding              -> weight
  bias                   -> bias
  text_projection        -> text_projection  (the CLIP tower's raw
                            [width, projection_dim] matrix, used as
                            ``pooled @ text_projection`` in both packages)
  pos_embed, decoder_pos_embed, mask_token,
  rel_pos_bias__relative_position_bias_table
                         -> the same name, ``__`` as ``.`` (MDT's raw
                            parameters, declared under their torch names
                            and layouts)

so parameters made by the JAX package load into the port's modules, whose
keys are the upstream torch keys.  The params tree is nested dicts of numpy
arrays (``jax.device_get`` of a Flax params tree), with or without the
top-level ``"params"`` wrapper.

The JAX MMDiT names its modules otherwise (``t_mlp0``, ``blocks__i/x_qkv``,
...): ``mmdit_key`` maps those keys onto SD3's upstream ones, the inverse of
the table of ``dmtpu/convert/zoo.py::convert_mmdit``.  A module with a
``flax_rename`` attribute (the port's MMDiT) has its keys renamed so by
``load_flax_params``.

The JAX pixel UNets store as dense layers what the reference (and the
port) holds as 1x1 convolutions: ``fit_to_module`` maps those onto the
module's keys and shapes when ``load_flax_params`` loads them.

SDXL's tree (``dmtpu.models.sdxl.StableDiffusionXL.init_params``: ``{"unet",
"vae", "conditioner": {"clip_l", "clip_g"}}``) needs no rule of its own:
``label_emb__0__0`` is ``label_emb.0.0`` and the linear ``proj_in`` /
``proj_out`` kernels are 2-D, so transposed as ``nn.Linear`` weights;
``sdxl_state_dict_from_flax`` puts the parts under the prefixes of the
port's ``StableDiffusionXL``.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_LEAF = {"scale": "weight", "embedding": "weight", "bias": "bias"}
# raw parameters (``self.param``) that carry their torch name and layout
_RAW = {"text_projection", "pos_embed", "decoder_pos_embed", "mask_token",
        "rel_pos_bias__relative_position_bias_table", "positional_embedding"}
# a Flax ``Dense`` wrapper's leaf whose port counterpart is a 1x1 conv
_DENSE_LEAF = re.compile(r"(.*)\.dense\.(weight|bias)")


def torch_name(path: Tuple[str, ...], ndim: int) -> Tuple[str, Optional[Tuple[int, ...]]]:
    """(torch key, axis permutation or None) for the Flax leaf at ``path``."""
    *mods, leaf = path
    base = ".".join(m.replace("__", ".") for m in mods)
    if leaf == "kernel":
        if ndim == 4:
            perm = (3, 2, 0, 1)
        elif ndim == 2:
            perm = (1, 0)
        else:
            raise ValueError(f"unsupported {ndim}-D kernel at {'/'.join(path)}")
        name = "weight"
    elif leaf in _LEAF:
        name, perm = _LEAF[leaf], None
    elif leaf in _RAW:
        name, perm = leaf.replace("__", "."), None
    else:
        raise ValueError(f"unknown Flax leaf {leaf!r} at {'/'.join(path)}")
    return (f"{base}.{name}" if base else name), perm


# the JAX MMDiT's top-level modules -> SD3's
_MMDIT_TOP = (("x_embedder.", "x_embedder.proj."), ("t_mlp0.", "t_embedder.mlp.0."),
              ("t_mlp2.", "t_embedder.mlp.2."), ("pooled_mlp0.", "y_embedder.mlp.0."),
              ("pooled_mlp2.", "y_embedder.mlp.2."))
# a block's modules, per stream (x, ctx) -> x_block / context_block
_MMDIT_BLOCK = (("adaLN.", "adaLN_modulation.1."), ("qkv.", "attn.qkv."),
                ("proj.", "attn.proj."), ("qknorm.q_norm.", "attn.ln_q."),
                ("qknorm.k_norm.", "attn.ln_k."), ("mlp.", "mlp."))
_MMDIT_BLOCK_KEY = re.compile(r"blocks\.(\d+)\.(x|ctx)_(.*)")


def mmdit_key(key: str) -> str:
    """The SD3 key of a JAX MMDiT leaf's torch key (``blocks.3.ctx_qkv.weight``
    -> ``joint_blocks.3.context_block.attn.qkv.weight``)."""
    for src, dst in _MMDIT_TOP:
        if key.startswith(src):
            return dst + key[len(src):]
    m = _MMDIT_BLOCK_KEY.fullmatch(key)
    if m is None:
        return key  # context_embedder, final_layer
    i, stream, rest = m.groups()
    block = "x_block" if stream == "x" else "context_block"
    for src, dst in _MMDIT_BLOCK:
        if rest.startswith(src):
            return f"joint_blocks.{i}.{block}.{dst}{rest[len(src):]}"
    raise ValueError(f"unrecognised JAX MMDiT leaf: {key}")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_flax(params: Mapping[str, Any],
                         rename: Optional[Callable[[str], str]] = None
                         ) -> dict[str, torch.Tensor]:
    """Torch state_dict (f32 CPU tensors) from a JAX-package params tree;
    ``rename`` maps each key once converted (``mmdit_key``)."""
    if set(params) == {"params"}:
        params = params["params"]
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        key, perm = torch_name(path, arr.ndim)
        if rename is not None:
            key = rename(key)
        if perm is not None:
            arr = arr.transpose(perm)
        if key in out:
            raise ValueError(f"two Flax leaves map to {key}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return out


def fit_to_module(state_dict: dict[str, torch.Tensor],
                  target: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``state_dict`` with the JAX package's dense layers put where the port
    (and the reference) has 1x1 convolutions: a ``<m>.dense.weight`` the
    module lacks goes to ``<m>.weight`` (the pixel UNets' q / k / v / proj),
    and a dense weight goes into a conv's [out, in, 1(, 1)] shape (ADM's
    kernel-1 qkv convolutions)."""
    out = {}
    for key, value in state_dict.items():
        m = _DENSE_LEAF.fullmatch(key)
        if key not in target and m is not None and f"{m[1]}.{m[2]}" in target:
            key = f"{m[1]}.{m[2]}"
        want = target.get(key)
        if want is not None and want.shape != value.shape and want.numel() == value.numel() \
                and want.shape[:value.dim()] == value.shape:
            value = value.reshape(want.shape)
        out[key] = value
    return out


def load_flax_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load a JAX-package params tree into ``module`` (strict: every key must
    match), through the module's ``flax_rename`` where it has one, with
    ``fit_to_module``'s dense-to-1x1-conv map.  Tensors are copied into the
    module's own dtypes and device."""
    sd = state_dict_from_flax(params, getattr(module, "flax_rename", None))
    module.load_state_dict(fit_to_module(sd, module.state_dict()), strict=True)
    return module


def sdxl_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's ``StableDiffusionXL`` state dict (``unet.``, ``vae.``,
    ``conditioner.clip_l.``, ``conditioner.clip_g.``) from the JAX package's
    SDXL params (``{"unet", "vae", "conditioner": {"clip_l", "clip_g"}}``;
    a part that is None is left out)."""
    parts = {"unet": params.get("unet"), "vae": params.get("vae")}
    for tower, tree in (params.get("conditioner") or {}).items():
        parts[f"conditioner.{tower}"] = tree
    return {f"{prefix}.{key}": value for prefix, tree in parts.items() if tree is not None
            for key, value in state_dict_from_flax(tree).items()}
