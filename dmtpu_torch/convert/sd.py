"""Key surgery on Stable Diffusion state dicts (CompVis, open_clip and
diffusers layouts).

Counterpart of the part of ``dmtpu/convert/sd.py`` that the port still
needs.  The port's modules carry the upstream torch keys, so a checkpoint
needs no structural conversion: only the prefixes of a CompVis checkpoint
(reference: models/stablediffusion/stablediffusion.py:73-79: the VAE under
``first_stage_model.``, the UNet under ``model.diffusion_model.``, the text
encoder under ``cond_stage_model.``) are split off, and the open_clip and
diffusers layouts renamed.  ``split_sdxl_checkpoint`` does the same for an
sgm SDXL checkpoint (the counterpart of ``convert_sdxl_checkpoint``,
``dmtpu/convert/sd.py:169-221``).  Values may be torch tensors or numpy arrays and
are passed through (the fused open_clip ``in_proj`` is split in three).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

StateDict = Dict[str, Any]


def _strip(state_dict: Mapping[str, Any], prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def _split3(v: Any):
    n = v.shape[0] // 3
    return v[:n], v[n:2 * n], v[2 * n:]


def openclip_text_to_hf(sd: Mapping[str, Any]) -> StateDict:
    """Rewrite an open_clip text tower's state dict into the HF CLIPText
    layout of ``CLIPTextTransformer`` (the fused in_proj split into q/k/v);
    ``logit_scale``, ``attn_mask`` and the visual tower are dropped."""
    top = {
        "token_embedding.weight": "embeddings.token_embedding.weight",
        "positional_embedding": "embeddings.position_embedding.weight",
        "text_projection": "text_projection",
        "ln_final.weight": "final_layer_norm.weight",
        "ln_final.bias": "final_layer_norm.bias",
    }
    out: StateDict = {}
    for k, v in sd.items():
        if k in top:
            out[top[k]] = v
        elif ".attn.in_proj_weight" in k or ".attn.in_proj_bias" in k:
            layer = k.split("resblocks.")[1].split(".")[0]
            leaf = "weight" if k.endswith("weight") else "bias"
            base = f"encoder.layers.{layer}.self_attn"
            for name, part in zip(("q_proj", "k_proj", "v_proj"), _split3(v)):
                out[f"{base}.{name}.{leaf}"] = part
        elif ".resblocks." in k:
            layer = k.split("resblocks.")[1].split(".")[0]
            rest = k.split(f"resblocks.{layer}.")[1]
            rest = (rest
                    .replace("attn.out_proj", "self_attn.out_proj")
                    .replace("ln_1", "layer_norm1")
                    .replace("ln_2", "layer_norm2")
                    .replace("mlp.c_fc", "mlp.fc1")
                    .replace("mlp.c_proj", "mlp.fc2"))
            out[f"encoder.layers.{layer}.{rest}"] = v
    return out


def hf_clip_text_strip(sd: Mapping[str, Any]) -> StateDict:
    """HF CLIPTextModel state dict -> the tower's layout: the ``text_model.``
    prefix and the ``position_ids`` buffer dropped."""
    return {k.replace("text_model.", ""): v for k, v in sd.items()
            if not k.endswith("position_ids")}


def diffusers_vae_to_compvis(sd: Mapping[str, Any]) -> StateDict:
    """diffusers AutoencoderKL state dict -> CompVis key layout.

    Handles both the modern (to_q / to_k / to_v / to_out.0) and the legacy
    (query / key / value / proj_attn) attention names of diffusers; the
    attention's Linear weights become 1x1-conv weights.
    """
    # the number of decoder levels, for the reversal of the up-block index
    n_up = 1 + max(
        (int(k.split("up_blocks.")[1].split(".")[0]) for k in sd if "up_blocks." in k),
        default=0)
    attn_map = {
        "group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out",
        "query": "q", "key": "k", "value": "v", "proj_attn": "proj_out",
    }
    out: StateDict = {}
    for k, v in sd.items():
        nk = k
        nk = nk.replace("mid_block.resnets.0", "mid.block_1")
        nk = nk.replace("mid_block.resnets.1", "mid.block_2")
        nk = nk.replace("mid_block.attentions.0", "mid.attn_1")
        if ".down_blocks." in nk:
            nk = nk.replace("down_blocks.", "down.")
            nk = nk.replace(".resnets.", ".block.")
            nk = nk.replace(".downsamplers.0.conv", ".downsample.conv")
        if ".up_blocks." in nk:
            i = int(nk.split("up_blocks.")[1].split(".")[0])
            nk = nk.replace(f"up_blocks.{i}.", f"up.{n_up - 1 - i}.")
            nk = nk.replace(".resnets.", ".block.")
            nk = nk.replace(".upsamplers.0.conv", ".upsample.conv")
        nk = nk.replace("conv_norm_out", "norm_out")
        nk = nk.replace(".conv_shortcut.", ".nin_shortcut.")
        if ".attn_1." in nk:
            for a, b in attn_map.items():
                if f".attn_1.{a}." in nk:
                    nk = nk.replace(f".attn_1.{a}.", f".attn_1.{b}.")
                    break
            if nk.endswith("weight") and v.ndim == 2:
                v = v[:, :, None, None]  # Linear -> 1x1 conv
        out[nk] = v
    return out


def split_sd_checkpoint(state_dict: Mapping[str, Any],
                        text_encoder_sd: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, Optional[StateDict]]:
    """A CompVis SD checkpoint -> ``{"unet", "vae", "text_encoder"}`` state
    dicts in the port's module layouts.

    ``text_encoder_sd``: an optional separate text-encoder state dict (HF or
    open_clip layout); without it the checkpoint's own ``cond_stage_model.``
    weights are used (``.transformer.`` is HF CLIP, ``.model.`` open_clip),
    and ``text_encoder`` is None where the checkpoint has neither.
    """
    if text_encoder_sd is None:
        if any(k.startswith("cond_stage_model.model.") for k in state_dict):
            text_encoder_sd = openclip_text_to_hf(_strip(state_dict, "cond_stage_model.model."))
        elif any(k.startswith("cond_stage_model.transformer.") for k in state_dict):
            text_encoder_sd = hf_clip_text_strip(
                _strip(state_dict, "cond_stage_model.transformer."))
    elif any(".resblocks." in k for k in text_encoder_sd):
        text_encoder_sd = openclip_text_to_hf(text_encoder_sd)
    else:
        text_encoder_sd = hf_clip_text_strip(text_encoder_sd)
    return {"unet": _strip(state_dict, "model.diffusion_model."),
            "vae": _strip(state_dict, "first_stage_model."),
            "text_encoder": text_encoder_sd or None}


def _clip_tower(sd: Mapping[str, Any]) -> StateDict:
    """A text tower's state dict in the HF or the open_clip layout -> the
    tower's layout."""
    if any(".resblocks." in k for k in sd):
        return openclip_text_to_hf(sd)
    return hf_clip_text_strip(sd)


def split_sdxl_checkpoint(state_dict: Mapping[str, Any],
                          clip_l_sd: Optional[Mapping[str, Any]] = None,
                          clip_g_sd: Optional[Mapping[str, Any]] = None
                          ) -> Dict[str, Optional[StateDict]]:
    """An sgm SDXL checkpoint -> ``{"unet", "vae", "clip_l", "clip_g"}``
    state dicts in the port's module layouts.

    The UNet is under ``model.diffusion_model.``, the VAE under
    ``first_stage_model.``, CLIP-L under ``conditioner.embedders.0.
    transformer.`` (HF layout) and bigG under ``conditioner.embedders.1.
    model.`` (open_clip layout); ``clip_l_sd`` / ``clip_g_sd`` (HF or
    open_clip layout) take the place of the checkpoint's towers.  A tower the
    checkpoint does not hold is None.
    """
    if clip_l_sd is None:
        clip_l_sd = _strip(state_dict, "conditioner.embedders.0.transformer.")
    if clip_g_sd is None:
        clip_g_sd = _strip(state_dict, "conditioner.embedders.1.model.")
    return {"unet": _strip(state_dict, "model.diffusion_model."),
            "vae": _strip(state_dict, "first_stage_model."),
            "clip_l": _clip_tower(clip_l_sd) if clip_l_sd else None,
            "clip_g": _clip_tower(clip_g_sd) if clip_g_sd else None}
