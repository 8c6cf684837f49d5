"""The SD cross-attention UNet, in NCHW.

Counterpart of ``dmtpu/models/stablediffusion/unet.py::SDUNetModel``
(reference: models/stablediffusion/unet.py:422-808) for the SD1.x / 2.x
fields.  Submodule names are the upstream torch ones (``input_blocks.1.0``,
``middle_block.1``, ``out.2``, ...), so upstream state dicts load as they
are, and ``dmtpu_torch.convert.load_flax_params`` loads the JAX package's
params.

``torso_dtype`` (a ``torch.dtype``, or its name as a config file gives it:
``"bfloat16"``) sets the dtype of the torso's convolutions and dense
layers; the time embedding, every GroupNorm and LayerNorm, the softmax and
the output head stay f32.

``use_checkpoint=True`` rematerialises every ResBlock and every
SpatialTransformer call in the backward pass, the calls the JAX module wraps
in ``remat_call``; dropout follows ``model.train()``.

The serving accelerators add no parameters (the ``state_dict`` is the same
with them on or off):

- Token Merging (``tome_ratio``, ``tome_sx``, ``tome_sy``, ``tome_seed``) in
  the SpatialTransformers of the levels with ``ds <= tome_max_downsample``
  (``dmtpu_torch/ops/tome.py``); ``set_tome`` changes it on a built model.
- FreeU (``freeu=(b1, b2, s1, s2)``, ``dmtpu_torch/ops/freeu.py``) at each
  decoder concat; ``set_freeu`` changes it.
- DeepCache passes (``forward``'s ``dc_skip`` / ``dc_cached``).

Options of the JAX module that are not ported raise ``NotImplementedError``
when set: the ``use_fp16`` / ``use_bf16`` aliases of ``torso_dtype``,
class / vector conditioning (``num_classes``, ``adm_in_channels``),
selective remat (a policy name as ``use_checkpoint``),
``use_linear_in_transformer``, per-level
``num_res_blocks`` / ``transformer_depth``, the SDXL structure fields
(``transformer_depth_middle``, ``disable_self_attentions``,
``num_attention_blocks``, ``disable_middle_*``), the non-spatial ADM
attention path (``use_spatial_transformer=False``, ``num_heads_upsample``,
``use_new_attention_order``).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from dmtpu_torch.models.adm import (
    Conv2d,
    GroupNorm32,
    ResBlock,
    _Downsample,
    _Upsample,
    _zeros_conv,
    timestep_embedding,
)
from dmtpu_torch.models.stablediffusion.attention import SpatialTransformer
from dmtpu_torch.ops.freeu import apply_freeu
from dmtpu_torch.ops.rematerialize import normalize_use_checkpoint, remat_call

# option -> the value that means "off"; anything else is not ported yet
_UNPORTED = {
    "use_fp16": False, "use_bf16": False,
    "num_classes": None, "adm_in_channels": None,
    "use_linear_in_transformer": False, "use_spatial_transformer": True,
    "spatial_transformer_attn_type": "softmax",
    # SDXL structure and the ADM-attention path's head options
    "transformer_depth_middle": None, "disable_self_attentions": None,
    "num_attention_blocks": None, "disable_middle_self_attn": False,
    "disable_middle_transformer": False, "num_heads_upsample": -1,
    "use_new_attention_order": False,
}


class TimestepEmbedSequential(nn.ModuleList):
    """One UNet block: ResBlocks take the embedding, SpatialTransformers the
    context, the rest only the features (reference: TimestepEmbedSequential).
    ``remat`` recomputes the ResBlocks and SpatialTransformers in the
    backward pass."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor, context: Optional[torch.Tensor],
                remat: bool = False) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, ResBlock):
                x = remat_call(layer, x, emb) if remat else layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = remat_call(layer, x, context) if remat else layer(x, context)
            else:
                x = layer(x)
        return x


class SDUNetModel(nn.Module):
    """SD1.x / 2.x UNet (see the module docstring)."""

    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int],
        image_size: Optional[int] = None,  # accepted for config parity; unused
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_heads: int = -1,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        transformer_depth: int = 1,
        context_dim: Optional[int] = None,
        legacy: bool = True,
        use_checkpoint: Any = False,
        torso_dtype: Optional[torch.dtype] = None,
        tome_ratio: float = 0.0,
        tome_sx: int = 2,
        tome_sy: int = 2,
        tome_max_downsample: int = 1,
        tome_seed: Optional[int] = None,
        freeu: Optional[Sequence[float]] = None,
        device: Any = None,
        **unported: Any,
    ):
        super().__init__()
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"SDUNetModel got an unexpected argument {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(f"SDUNetModel option {name}={value!r} is not ported")
        for name, value in (("num_res_blocks", num_res_blocks),
                            ("transformer_depth", transformer_depth)):
            if not isinstance(value, int):
                raise NotImplementedError(f"per-level {name} is not ported")
        if isinstance(torso_dtype, str):  # a YAML config names the dtype
            torso_dtype = getattr(torch, torso_dtype)
        self.torso_dtype = torso_dtype
        self.use_checkpoint = normalize_use_checkpoint(use_checkpoint)
        self.num_heads, self.num_head_channels, self.legacy = num_heads, num_head_channels, legacy
        ted = model_channels * 4
        kw = dict(dtype=torso_dtype, device=device)

        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, ted, device=device), nn.SiLU(),
            nn.Linear(ted, ted, device=device))
        self.model_channels = model_channels

        def res(ch_in, ch_out, **extra):
            return ResBlock(ch_in, ted, ch_out, dropout,
                            use_scale_shift_norm=use_scale_shift_norm, **extra, **kw)

        def st(ch):
            heads, dim_head = self._dim_head(ch)
            module = SpatialTransformer(ch, heads, dim_head, depth=transformer_depth,
                                        context_dim=context_dim, **kw)
            module.ds = ds  # the level, read where the module is built
            return module

        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(
            [Conv2d(in_channels, model_channels, 3, padding=1, **kw)])])
        chans = [model_channels]
        ch, ds = model_channels, 1
        for level, mult in enumerate(channel_mult):
            for nr in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(st(ch))
                self.input_blocks.append(TimestepEmbedSequential(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                down = (res(ch, ch, down=True) if resblock_updown else
                        _Downsample(ch, ch, conv_resample, **kw))
                self.input_blocks.append(TimestepEmbedSequential([down]))
                chans.append(ch)
                ds *= 2

        self.middle_block = TimestepEmbedSequential([res(ch, ch), st(ch), res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(st(ch))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True) if resblock_updown else
                                  _Upsample(ch, ch, conv_resample, **kw))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(layers))

        self.out = nn.Sequential(GroupNorm32(ch, device=device), nn.SiLU(),
                                 _zeros_conv(ch, out_channels, 3, device=device))
        self.set_tome(tome_ratio, tome_sx, tome_sy, tome_max_downsample, tome_seed)
        self.set_freeu(freeu)

    def set_tome(self, ratio: float, sx: int = 2, sy: int = 2, max_downsample: int = 1,
                 seed: Optional[int] = None) -> "SDUNetModel":
        """Token Merging at ``ratio`` (0 = off) in the SpatialTransformers of the
        levels with ``ds <= max_downsample``."""
        self.tome_ratio, self.tome_sx, self.tome_sy = float(ratio), int(sx), int(sy)
        self.tome_max_downsample, self.tome_seed = int(max_downsample), seed
        for st in self.modules():
            if isinstance(st, SpatialTransformer):
                for block in st.transformer_blocks:
                    block.tome_ratio = self.tome_ratio if st.ds <= max_downsample else 0.0
                    block.tome_sx, block.tome_sy, block.tome_seed = self.tome_sx, self.tome_sy, seed
        return self

    def set_freeu(self, scales: Optional[Sequence[float]]) -> "SDUNetModel":
        """FreeU with ``scales`` = (b1, b2, s1, s2), or off (None)."""
        if scales is not None:
            scales = tuple(float(s) for s in scales)
            if len(scales) != 4:
                raise ValueError(f"FreeU needs exactly (b1, b2, s1, s2), got {len(scales)}")
        self.freeu = scales
        return self

    def _dim_head(self, ch: int):
        """The reference's head-dim resolution (spatial-transformer branch)."""
        if self.num_head_channels == -1:
            num_heads, dim_head = self.num_heads, ch // self.num_heads
        else:
            num_heads, dim_head = ch // self.num_head_channels, self.num_head_channels
        if self.legacy:
            dim_head = ch // num_heads
        return num_heads, dim_head

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                dc_skip: Optional[int] = None, dc_cached: Optional[torch.Tensor] = None
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x: [B, C, H, W]; timesteps: [B]; context: [B, T, context_dim].

        DeepCache passes (Ma et al. 2023):

        - ``dc_skip=None``: the plain forward; returns ``out``.
        - ``dc_skip=k``, no ``dc_cached``: FULL pass; returns ``(out, u)``,
          ``u`` the up-path feature entering the last ``k`` output blocks.
        - ``dc_skip=k``, ``dc_cached=u``: SHALLOW pass: only the first ``k``
          input blocks and the last ``k`` output blocks run, with ``u``
          spliced in; returns ``(out, u)``.
        """
        if y is not None:
            raise NotImplementedError("class / vector conditioning (y) is not ported")
        total_pops = len(self.output_blocks)
        if dc_skip is None:
            if dc_cached is not None:
                raise ValueError("dc_cached needs dc_skip")
        elif not 0 < dc_skip <= total_pops:
            raise ValueError(f"dc_skip must be in [1, {total_pops}], got {dc_skip}")
        shallow = dc_cached is not None
        boundary = total_pops - (dc_skip or 0)

        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        h = x
        hs = []
        remat = self.use_checkpoint
        for block in self.input_blocks[:dc_skip] if shallow else self.input_blocks:
            h = block(h, emb, context, remat)
            hs.append(h)
        if not shallow:
            h = self.middle_block(h, emb, context, remat)
        u = dc_cached
        for i, block in enumerate(self.output_blocks):
            if i < boundary and shallow:
                continue
            if i == boundary and dc_skip is not None:
                if shallow:
                    h = dc_cached  # splice the cached deep feature
                else:
                    u = h  # capture the input of the first shallow block
            skip = hs.pop()
            if self.freeu is not None:
                h, skip = apply_freeu(h, skip, self.model_channels, *self.freeu)
            h = block(torch.cat([h, skip], dim=1), emb, context, remat)
        h = self.out[0](h.to(x.dtype), silu=True)
        out = self.out[2](h)
        return out if dc_skip is None else (out, u)
