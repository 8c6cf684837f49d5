"""The SD / SDXL cross-attention UNet, in NCHW.

Counterpart of ``dmtpu/models/stablediffusion/unet.py::SDUNetModel``, the
superset of the SD1.x / 2.x UNet (reference: models/stablediffusion/unet.py:
422-808) and SDXL's (reference: models/sdxl/unet.py:456-837).  Submodule
names are the upstream torch ones (``input_blocks.1.0``, ``middle_block.1``,
``label_emb.0.0``, ``out.2``, ...), so upstream state dicts load as they
are, and ``dmtpu_torch.convert.load_flax_params`` loads the JAX package's
params.

``torso_dtype`` (a ``torch.dtype``, or its name as a config file gives it:
``"bfloat16"``; the reference's ``use_fp16`` / ``use_bf16`` switches mean
bf16, as ``resolve_torso_dtype`` reads them) sets the dtype of the torso's
convolutions and dense layers; the time and label embeddings, every
GroupNorm and LayerNorm, the softmax and the output head stay f32.

The SDXL options: ``num_classes`` (an int: ``nn.Embedding``; ``"continuous"``:
a dense layer on the scalar; ``"sequential"``: two dense layers on the
``adm_in_channels`` vector, SDXL's; ``"timestep"``: two dense layers on the
sinusoidal embedding of the scalar), with ``forward``'s ``y``; per-level
``num_res_blocks`` and ``transformer_depth``; ``transformer_depth_middle``;
``disable_self_attentions`` / ``num_attention_blocks`` per level;
``disable_middle_self_attn`` and ``disable_middle_transformer`` (the middle
block keeps the index ``middle_block.2``); ``use_linear_in_transformer``.
``spatial_transformer_attn_type`` is taken and ignored, as the JAX module
does: every attention goes through ``dmtpu_torch.ops.attention``.

``use_checkpoint=True`` rematerialises every ResBlock and every
SpatialTransformer call in the backward pass, the calls the JAX module wraps
in ``remat_call``; a policy name (``"dots"``, ``"attn"``, ...) keeps what
that policy keeps (``dmtpu_torch/ops/rematerialize.py``); dropout follows
``model.train()``.

The serving accelerators add no parameters (the ``state_dict`` is the same
with them on or off):

- Token Merging (``tome_ratio``, ``tome_sx``, ``tome_sy``, ``tome_seed``) in
  the SpatialTransformers of the levels with ``ds <= tome_max_downsample``
  (``dmtpu_torch/ops/tome.py``); ``set_tome`` changes it on a built model.
- FreeU (``freeu=(b1, b2, s1, s2)``, ``dmtpu_torch/ops/freeu.py``) at each
  decoder concat; ``set_freeu`` changes it.
- DeepCache passes (``forward``'s ``dc_skip`` / ``dc_cached``).

The ADM-attention path (``use_spatial_transformer=False``): the attention
layers are guided-diffusion's ``AttentionBlock`` (``dmtpu_torch/models/
adm.py``; no context) with the JAX module's head rule (``legacy`` takes
``num_head_channels`` as the head dim), ``num_heads_upsample`` heads in the
decoder and ``use_new_attention_order``'s qkv layout.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from dmtpu_torch.models.adm import (
    AttentionBlock,
    Conv2d,
    GroupNorm32,
    ResBlock,
    TimestepEmbedSequential,
    _Downsample,
    _Upsample,
    _zeros_conv,
    resolve_torso_dtype,
    timestep_embedding,
)
from dmtpu_torch.models.stablediffusion.attention import SpatialTransformer
from dmtpu_torch.ops.freeu import apply_freeu
from dmtpu_torch.ops.rematerialize import normalize_use_checkpoint


class _Timestep(nn.Module):
    """The sinusoidal embedding of a scalar (reference: sgm's ``Timestep``;
    no parameters)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return timestep_embedding(t.reshape(-1), self.dim)


def _label_embedding(num_classes: Union[int, str], model_channels: int, ted: int,
                     adm_in_channels: Optional[int], device: Any) -> nn.Module:
    """The ``label_emb`` module of ``num_classes``, in upstream keys (f32, as
    the JAX module's dense layers)."""
    if isinstance(num_classes, int):
        return nn.Embedding(num_classes, ted, device=device)
    if num_classes == "continuous":
        return nn.Linear(1, ted, device=device)
    if num_classes == "sequential":
        if adm_in_channels is None:
            raise ValueError("num_classes='sequential' needs adm_in_channels")
        return nn.Sequential(nn.Sequential(nn.Linear(adm_in_channels, ted, device=device),
                                           nn.SiLU(), nn.Linear(ted, ted, device=device)))
    if num_classes == "timestep":
        return nn.Sequential(_Timestep(model_channels), nn.Sequential(
            nn.Linear(model_channels, ted, device=device), nn.SiLU(),
            nn.Linear(ted, ted, device=device)))
    raise ValueError(f"unsupported num_classes {num_classes!r}")


def _per_level(value: Union[int, Sequence[int]], levels: int, name: str) -> list:
    if isinstance(value, int):
        return [value] * levels
    value = [int(v) for v in value]
    if len(value) != levels:
        raise ValueError(f"{name} has {len(value)} entries for {levels} levels")
    return value


class SDUNetModel(nn.Module):
    """The SD1.x / 2.x and SDXL UNet (see the module docstring)."""

    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: Union[int, Sequence[int]],
        attention_resolutions: Sequence[int],
        image_size: Optional[int] = None,  # accepted for config parity; unused
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        num_classes: Optional[Union[int, str]] = None,
        num_heads: int = -1,
        num_head_channels: int = -1,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_new_attention_order: bool = False,
        use_spatial_transformer: bool = True,
        transformer_depth: Union[int, Sequence[int]] = 1,
        transformer_depth_middle: Optional[int] = None,
        context_dim: Optional[int] = None,
        legacy: bool = True,
        disable_self_attentions: Optional[Sequence[bool]] = None,
        num_attention_blocks: Optional[Sequence[int]] = None,
        disable_middle_self_attn: bool = False,
        disable_middle_transformer: bool = False,
        use_linear_in_transformer: bool = False,
        adm_in_channels: Optional[int] = None,
        use_checkpoint: Any = False,
        use_fp16: bool = False,
        use_bf16: bool = False,
        spatial_transformer_attn_type: str = "softmax",  # accepted and ignored, as in JAX
        torso_dtype: Optional[torch.dtype] = None,
        tome_ratio: float = 0.0,
        tome_sx: int = 2,
        tome_sy: int = 2,
        tome_max_downsample: int = 1,
        tome_seed: Optional[int] = None,
        freeu: Optional[Sequence[float]] = None,
        device: Any = None,
    ):
        super().__init__()
        levels = len(channel_mult)
        nrb = _per_level(num_res_blocks, levels, "num_res_blocks")
        tdepth = _per_level(transformer_depth, levels, "transformer_depth")
        tdepth_mid = transformer_depth_middle or tdepth[-1]
        torso_dtype = resolve_torso_dtype(torso_dtype, use_fp16, use_bf16)
        self.torso_dtype = torso_dtype
        self.use_checkpoint, self.remat_policy = normalize_use_checkpoint(use_checkpoint)
        self.num_heads, self.num_head_channels, self.legacy = num_heads, num_head_channels, legacy
        self.use_spatial_transformer = use_spatial_transformer
        self.in_channels, self.context_dim = in_channels, context_dim
        self.num_classes, self.adm_in_channels = num_classes, adm_in_channels
        ted = model_channels * 4
        kw = dict(dtype=torso_dtype, device=device)

        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, ted, device=device), nn.SiLU(),
            nn.Linear(ted, ted, device=device))
        if num_classes is not None:
            self.label_emb = _label_embedding(num_classes, model_channels, ted,
                                              adm_in_channels, device)
        self.model_channels = model_channels

        def res(ch_in, ch_out, **extra):
            return ResBlock(ch_in, ted, ch_out, dropout,
                            use_scale_shift_norm=use_scale_shift_norm, **extra, **kw)

        def st(ch, depth, disable_self_attn, heads_override=None):
            heads, dim_head = self._dim_head(ch)
            if not use_spatial_transformer:
                return AttentionBlock(ch, heads_override or heads, dim_head,
                                      use_new_attention_order, **kw)
            module = SpatialTransformer(ch, heads, dim_head, depth=depth,
                                        context_dim=context_dim,
                                        disable_self_attn=disable_self_attn,
                                        use_linear=use_linear_in_transformer, **kw)
            module.ds = ds  # the level, read where the module is built
            return module

        def attends(level: int, i: int) -> bool:
            return ds in attention_resolutions and (
                num_attention_blocks is None or i < num_attention_blocks[level])

        def self_off(level: int) -> bool:
            return bool(disable_self_attentions[level]) if disable_self_attentions else False

        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(
            [Conv2d(in_channels, model_channels, 3, padding=1, **kw)])])
        chans = [model_channels]
        ch, ds = model_channels, 1
        for level, mult in enumerate(channel_mult):
            for nr in range(nrb[level]):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if attends(level, nr):
                    layers.append(st(ch, tdepth[level], self_off(level)))
                self.input_blocks.append(TimestepEmbedSequential(layers))
                chans.append(ch)
            if level != levels - 1:
                down = (res(ch, ch, down=True) if resblock_updown else
                        _Downsample(ch, ch, conv_resample, **kw))
                self.input_blocks.append(TimestepEmbedSequential([down]))
                chans.append(ch)
                ds *= 2

        # without its transformer the middle block keeps ``middle_block.2``
        middle = (nn.Identity() if disable_middle_transformer
                  else st(ch, tdepth_mid, disable_middle_self_attn))
        self.middle_block = TimestepEmbedSequential([res(ch, ch), middle, res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(nrb[level] + 1):
                layers = [res(ch + chans.pop(), model_channels * mult)]
                ch = model_channels * mult
                if attends(level, i):
                    layers.append(st(ch, tdepth[level], self_off(level),
                                     num_heads_upsample if num_heads_upsample != -1 else None))
                if level and i == nrb[level]:
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
        """The reference's head-dim resolution: with ``legacy`` the
        SpatialTransformer takes ch // heads, the ADM ``AttentionBlock``
        ``num_head_channels``."""
        if self.num_head_channels == -1:
            num_heads, dim_head = self.num_heads, ch // self.num_heads
        else:
            num_heads, dim_head = ch // self.num_head_channels, self.num_head_channels
        if self.legacy:
            dim_head = ch // num_heads if self.use_spatial_transformer else self.num_head_channels
        return num_heads, dim_head

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None, y: Optional[torch.Tensor] = None,
                dc_skip: Optional[int] = None, dc_cached: Optional[torch.Tensor] = None
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x: [B, C, H, W]; timesteps: [B]; context: [B, T, context_dim];
        ``y``: the labels of a ``num_classes`` model ([B] class ids or
        scalars, or the [B, adm_in_channels] vector of "sequential").

        DeepCache passes (Ma et al. 2023):

        - ``dc_skip=None``: the plain forward; returns ``out``.
        - ``dc_skip=k``, no ``dc_cached``: FULL pass; returns ``(out, u)``,
          ``u`` the up-path feature entering the last ``k`` output blocks.
        - ``dc_skip=k``, ``dc_cached=u``: SHALLOW pass: only the first ``k``
          input blocks and the last ``k`` output blocks run, with ``u``
          spliced in; returns ``(out, u)``.
        """
        total_pops = len(self.output_blocks)
        if dc_skip is None:
            if dc_cached is not None:
                raise ValueError("dc_cached needs dc_skip")
        elif not 0 < dc_skip <= total_pops:
            raise ValueError(f"dc_skip must be in [1, {total_pops}], got {dc_skip}")
        shallow = dc_cached is not None
        boundary = total_pops - (dc_skip or 0)

        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        if self.num_classes is None:
            if y is not None:
                raise ValueError("y (class / vector conditioning) given to a model without "
                                 "num_classes")
        elif y is None:
            raise ValueError("class-conditional model requires y")
        elif isinstance(self.num_classes, int):
            emb = emb + self.label_emb(y.long())
        elif self.num_classes == "continuous":
            emb = emb + self.label_emb(y.float().reshape(-1, 1))
        else:
            emb = emb + self.label_emb(y.float())
        h = x
        hs = []
        remat = self.use_checkpoint
        for block in self.input_blocks[:dc_skip] if shallow else self.input_blocks:
            h = block(h, emb, context, remat, policy=self.remat_policy)
            hs.append(h)
        if not shallow:
            h = self.middle_block(h, emb, context, remat, policy=self.remat_policy)
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
            h = block(torch.cat([h, skip], dim=1), emb, context, remat, policy=self.remat_policy)
        h = self.out[0](h.to(x.dtype), silu=True)
        out = self.out[2](h)
        return out if dc_skip is None else (out, u)
