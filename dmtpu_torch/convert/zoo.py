"""Key surgery on the model zoo's upstream checkpoints.

Counterpart of ``convert_mmdit`` in ``dmtpu/convert/zoo.py`` and of the
SD3 single-file splitting of ``scripts/convert_checkpoint.py``
(``convert_sd3_vae``).  The port's MMDiT carries SD3's upstream module
keys, so an SD3 release file
(``sd3_medium.safetensors``: the MMDiT under ``model.diffusion_model.``,
the 16-channel VAE under ``first_stage_model.``, the text towers under
``text_encoders.``) needs its prefixes split off and nothing renamed.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

from torch import nn

StateDict = Dict[str, Any]

_MMDIT_PREFIX = "model.diffusion_model."
_VAE_PREFIX = "first_stage_model."
# the other parts of a single-file release, and anything else under ``model.``
_SKIPPED = ("first_stage_model.", "vae.", "text_encoders.", "conditioner.", "model.")


def _check_keys(out: StateDict, model: nn.Module, what: str) -> StateDict:
    want = model.state_dict()
    unknown = sorted(set(out) - set(want))
    if unknown:
        raise ValueError(f"unrecognised {what} tensors: {unknown[:5]}")
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"{what} tensors the checkpoint lacks (unfilled): {missing[:5]}")
    return out


def convert_sd3_vae(state_dict: Mapping[str, Any], model: nn.Module) -> StateDict:
    """The VAE of an SD3 single-file release (its ``first_stage_model.``
    tensors, the prefix stripped), or a state dict of the VAE's own keys, as
    ``model``'s state dict; raises on a tensor either side lacks.  (SD3's
    released VAE has no ``quant_conv`` / ``post_quant_conv``, which
    ``AutoencoderKL`` builds: such a file is refused as unfilled.)"""
    if any(k.startswith(_VAE_PREFIX) for k in state_dict):
        state_dict = {k[len(_VAE_PREFIX):]: v for k, v in state_dict.items()
                      if k.startswith(_VAE_PREFIX)}
    return _check_keys(dict(state_dict), model, "VAE")


def convert_mmdit(state_dict: Mapping[str, Any], model: nn.Module) -> StateDict:
    """An SD3 / SD3.5 MMDiT checkpoint (the single-file release, or the
    MMDiT's own keys) as ``model``'s state dict: prefixes stripped, the VAE
    and text-tower tensors and ``pos_embed`` (a buffer the model builds;
    set ``pos_embed_max_size`` to the release's base grid, 192 for
    SD3-medium) dropped.  Raises on SD3.5-medium's dual attention
    (``attn2``), which this MMDiT does not have, and on a tensor the model
    lacks or one of the model's that the checkpoint lacks."""
    state_dict = {(k[len(_MMDIT_PREFIX):] if k.startswith(_MMDIT_PREFIX) else k): v
                  for k, v in state_dict.items()
                  if k.startswith(_MMDIT_PREFIX) or not k.startswith(_SKIPPED)}
    attn2 = [k for k in state_dict if ".attn2." in k]
    if attn2:
        raise ValueError(f"SD3.5-medium MMDiT-X dual-attention (attn2) checkpoints are not "
                         f"supported (one joint attention a block): {attn2[0]}")
    out = {k: v for k, v in state_dict.items() if k != "pos_embed" and not k.endswith(".pos_embed")}
    return _check_keys(out, model, "MMDiT")
