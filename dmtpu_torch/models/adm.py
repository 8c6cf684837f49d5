"""The OpenAI ADM (guided-diffusion) UNet family, in NCHW.

Counterpart of ``dmtpu/models/adm.py`` (reference: models/adm/unet.py,
models/adm/nn.py, models/adm/unet_combined.py): ``timestep_embedding``,
GroupNorm32, ``_zeros_conv``, ``_Upsample``, ``_Downsample``, ``ResBlock``
(which the SD UNet imports too), ``AttentionBlock`` (legacy and new qkv
order), ``AttentionPool2d``, ``UNetModel``, ``SuperResModel``,
``EncoderUNetModel`` and ``UNetCombined``.  Module and parameter names are
the upstream torch ones (``in_layers.0``, ``emb_layers.1``, ``qkv``,
``input_blocks.1.0``, ...), so upstream state dicts load as they are, even
where ``forward`` fuses a GroupNorm and its SiLU into one ``group_norm``
call.  Attention goes through ``ops.attention`` (K1 on a CUDA tensor), every
GroupNorm through ``ops.group_norm`` (K3).

Torso dtype: the JAX package computes the torso's convolutions and dense
layers in ``torso_dtype`` (bf16) from f32 params (Flax ``dtype`` with f32
``param_dtype``).  Here too the torso's ``Conv2d`` and ``Linear`` hold f32
parameters and cast input, weight and bias to ``torso_dtype`` in
``forward``, as Flax's ``promote_dtype`` does, so a gradient reaches the f32
parameter and an optimizer step smaller than a bf16 ulp is kept.
GroupNorm and LayerNorm params stay f32 and normalise in f32.  A module
that has the JAX package's ``param_dtype`` (MMDiT) passes it on as
``Linear`` / ``Conv2d``'s ``param_dtype``: the storage dtype, f32 unless
given.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.ops.attention import attention
from dmtpu_torch.ops.groupnorm import group_norm, group_norm_silu_reference
from dmtpu_torch.ops.rematerialize import normalize_use_checkpoint, remat_call


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """ADM sinusoidal embedding: cos-first, freqs = exp(-ln(P)·i/half), with
    f64 host freqs cast to f32 and an f32 product (reference: models/adm/nn.py:103-122)."""
    half = dim // 2
    freqs = np.exp(-math.log(max_period) * np.arange(half, dtype=np.float64) / half)
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(timesteps.device)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def resolve_torso_dtype(torso_dtype, use_fp16: bool = False, use_bf16: bool = False):
    """The torso dtype of a config: ``torso_dtype`` (a ``torch.dtype`` or its
    name) where given, else bf16 for the reference's ``use_fp16`` /
    ``use_bf16`` switches, else None (f32).  Counterpart of
    ``dmtpu/models/adm.py::resolve_torso_dtype``: an fp16 config computes in
    bf16 here too."""
    if isinstance(torso_dtype, str):  # a YAML config names the dtype
        torso_dtype = getattr(torch, torso_dtype)
    if torso_dtype is not None:
        return torso_dtype
    return torch.bfloat16 if use_fp16 or use_bf16 else None


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with parameters stored in ``param_dtype`` (f32 when None)
    that computes in ``dtype`` (the torso dtype; f32 when None): input,
    weight and bias are cast to it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None, device=None, param_dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with parameters stored in ``param_dtype`` (f32 when None)
    that computes in ``dtype`` (the torso dtype; f32 when None): input,
    weight and bias are cast to it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype=None, device=None, param_dtype=None, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv1d(nn.Conv1d):
    """A kernel-1 ``nn.Conv1d`` (the reference's ``conv_nd(1, ...)`` q/k/v
    projections, weight [out, in, 1]) that computes in ``dtype``; the models
    apply it to [B, S, C] tokens through ``pointwise``."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None, device=None):
        super().__init__(in_channels, out_channels, 1, device=device)
        self.compute_dtype = dtype or torch.float32


def pointwise(conv: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``Conv2d`` or kernel-1 ``Conv1d`` applied to [B, S, C_in] tokens
    as the dense layer it is, in the conv's compute dtype."""
    dt = getattr(conv, "compute_dtype", torch.float32)
    weight = conv.weight.reshape(conv.weight.shape[0], -1).to(dt)
    return F.linear(tokens.to(dt), weight, _cast(conv.bias, dt))


def tokens_of(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C] (a view when ``x`` is channels-last)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def image_of(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*W, C] -> [B, C, H, W], channels-last in memory."""
    b, _, c = tokens.shape
    return tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)


class GroupNorm32(nn.GroupNorm):
    """32 groups, f32 params and math, the output in the input's dtype
    (reference: models/adm/nn.py GroupNorm32).  ``silu=True`` fuses the SiLU
    that follows it into the same ``group_norm`` call."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__(32, channels, eps=eps, device=device)

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, silu)


def _zeros_conv(in_ch: int, out_ch: int, kernel: int, padding: int = 1, dtype=None,
                device=None) -> Conv2d:
    """zero_module'd conv (reference: models/adm/nn.py:68-74)."""
    conv = Conv2d(in_ch, out_ch, kernel, padding=padding, dtype=dtype, device=device)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class _Upsample(nn.Module):
    """(reference: models/adm/unet.py:97-130)"""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True, dtype=None, device=None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = Conv2d(channels, out_channels or channels, 3, padding=1,
                               dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x) if self.use_conv else x


class _Downsample(nn.Module):
    """(reference: models/adm/unet.py:132-159)"""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 use_conv: bool = True, dtype=None, device=None):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = Conv2d(channels, out_channels or channels, 3, stride=2, padding=1,
                             dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x) if self.use_conv else F.avg_pool2d(x, 2)


class ResBlock(nn.Module):
    """(reference: models/adm/unet.py:162-276)

    ``in_layers`` = (GroupNorm32, SiLU, conv), ``emb_layers`` = (SiLU,
    Linear), ``out_layers`` = (GroupNorm32, SiLU, Dropout, zero conv); each
    GroupNorm+SiLU pair runs as one fused op.  The dropout is active under
    ``train=True`` and off under ``train=False``, whatever the module's mode,
    as the JAX module's ``deterministic=not train``; the ADM UNets pass it.
    Without it (the SD UNet's calls) it follows the module's mode.
    """

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 dropout: float = 0.0, use_conv: bool = False,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False,
                 dtype=None, device=None):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, device=device), nn.SiLU(),
            Conv2d(channels, out_ch, 3, padding=1, dtype=dtype, device=device))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch,
                              dtype=dtype, device=device))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_ch, device=device), nn.SiLU(), nn.Dropout(dropout),
            _zeros_conv(out_ch, out_ch, 3, dtype=dtype, device=device))
        if out_ch == channels:
            self.skip_connection = nn.Identity()
        elif use_conv:
            self.skip_connection = Conv2d(channels, out_ch, 3, padding=1, dtype=dtype,
                                          device=device)
        else:
            self.skip_connection = Conv2d(channels, out_ch, 1, dtype=dtype, device=device)

    def _updown(self, z: torch.Tensor) -> torch.Tensor:
        if self.up:
            return F.interpolate(z, scale_factor=2, mode="nearest")
        if self.down:
            return F.avg_pool2d(z, 2)
        return z

    def forward(self, x: torch.Tensor, emb: torch.Tensor, *, train: Optional[bool] = None
                ) -> torch.Tensor:
        h = self.in_layers[0](x, silu=True)
        if self.up or self.down:
            h, x = self._updown(h), self._updown(x)
        h = self.in_layers[2](h)
        emb_out = self.emb_layers[1](F.silu(emb)).to(h.dtype)[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        else:
            h = self.out_layers[0](h + emb_out, silu=True)
        train = self.training if train is None else train
        h = self.out_layers[3](F.dropout(h, self.out_layers[2].p, train))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """GroupNorm -> qkv (kernel-1 conv) -> multi-head attention over the H*W
    tokens -> zero-initialised proj_out, residual.  (reference:
    models/adm/unet.py:278-325 + 347-411)

    ``new_order=False`` reads the qkv channels as QKVAttentionLegacy does
    (heads x (q, k, v) x ch), ``new_order=True`` as QKVAttention ((q, k, v) x
    heads x ch).  The JAX package calls its plain ``mha`` here; the port goes
    through ``ops.attention``, K1 on a CUDA tensor (the same function: f32
    softmax of q.k / sqrt(ch)), the plain ``mha`` on the CPU.
    """

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 new_order: bool = False, dtype=None, device=None):
        super().__init__()
        self.heads = num_heads if num_head_channels == -1 else channels // num_head_channels
        self.new_order = new_order
        self.norm = GroupNorm32(channels, device=device)
        self.qkv = Conv1d(channels, 3 * channels, dtype=dtype, device=device)
        self.proj_out = Conv1d(channels, channels, dtype=dtype, device=device)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        heads, hd = self.heads, c // self.heads
        qkv = pointwise(self.qkv, tokens_of(self.norm(x)))
        if self.new_order:
            q, k, v = qkv.view(b, h * w, 3, heads, hd).unbind(2)
        else:
            q, k, v = qkv.view(b, h * w, heads, 3, hd).unbind(3)
        out = attention(q, k, v, scale=1.0 / math.sqrt(hd))
        out = pointwise(self.proj_out, out.reshape(b, h * w, c))
        return x + image_of(out, h, w)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling: the mean token and the H*W tokens plus
    a learned position embedding, attention in the new qkv order, the mean
    token's output.  (reference: models/adm/unet.py:40-73)  The JAX module
    computes in f32; here ``dtype`` (the encoder's torso dtype) sets the
    dtype of its projections and attention, so that K1 takes it on the card."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads_channels: int,
                 output_dim: Optional[int] = None, dtype=None, device=None):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1, device=device) / embed_dim ** 0.5)
        self.qkv_proj = Conv1d(embed_dim, 3 * embed_dim, dtype=dtype, device=device)
        self.c_proj = Conv1d(embed_dim, output_dim or embed_dim, dtype=dtype, device=device)
        self.heads = embed_dim // num_heads_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        tokens = tokens_of(x)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.t()[None].to(tokens.dtype)
        s, hd = tokens.shape[1], c // self.heads
        q, k, v = pointwise(self.qkv_proj, tokens).view(b, s, 3, self.heads, hd).unbind(2)
        out = attention(q, k, v, scale=1.0 / math.sqrt(hd))
        return pointwise(self.c_proj, out.reshape(b, s, c))[:, 0]


class TimestepEmbedSequential(nn.ModuleList):
    """One UNet block (reference: TimestepEmbedSequential): ResBlocks take
    the embedding, layers with ``takes_context`` (SpatialTransformer) the
    context, the rest only the features.  ``remat`` recomputes the ResBlocks
    and the attention layers in the backward pass, the calls the JAX modules
    wrap in ``remat_call``; ``train``, where given, reaches the ResBlocks'
    dropout."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor, context: Optional[torch.Tensor] = None,
                remat: bool = False, train: Optional[bool] = None) -> torch.Tensor:
        kw = {} if train is None else {"train": train}
        for layer in self:
            if isinstance(layer, ResBlock):
                x = remat_call(layer, x, emb, **kw) if remat else layer(x, emb, **kw)
            elif getattr(layer, "takes_context", False):
                x = remat_call(layer, x, context) if remat else layer(x, context)
            elif isinstance(layer, AttentionBlock):
                x = remat_call(layer, x) if remat else layer(x)
            else:
                x = layer(x)
        return x


class _BlockFactory:
    """The ResBlock / attention / resampling factories of one ADM UNet."""

    def __init__(self, ted: int, dropout: float, use_scale_shift_norm: bool,
                 resblock_updown: bool, conv_resample: bool, num_head_channels: int,
                 new_order: bool, dtype, device):
        self.ted, self.dropout, self.ssn = ted, dropout, use_scale_shift_norm
        self.updown, self.conv_resample = resblock_updown, conv_resample
        self.num_head_channels, self.new_order = num_head_channels, new_order
        self.dtype, self.device = dtype, device

    def __call__(self, ch: int, out: Optional[int] = None, **updown) -> ResBlock:
        return ResBlock(ch, self.ted, out, self.dropout, use_scale_shift_norm=self.ssn,
                        dtype=self.dtype, device=self.device, **updown)

    def attn(self, ch: int, heads: int) -> AttentionBlock:
        return AttentionBlock(ch, heads, self.num_head_channels, self.new_order,
                              dtype=self.dtype, device=self.device)

    def down(self, ch: int) -> nn.Module:
        return (self(ch, ch, down=True) if self.updown else
                _Downsample(ch, ch, self.conv_resample, dtype=self.dtype, device=self.device))

    def up(self, ch: int) -> nn.Module:
        return (self(ch, ch, up=True) if self.updown else
                _Upsample(ch, ch, self.conv_resample, dtype=self.dtype, device=self.device))

    def encoder(self, in_channels: int, model_channels: int, channel_mult: Sequence[int],
                num_res_blocks: int, attention_resolutions: Sequence[int], heads: int
                ) -> Tuple[nn.ModuleList, list, int, int]:
        """The encoder half shared by ``UNetModel`` and ``EncoderUNetModel``:
        (input_blocks, each block's output channels, channels, ds at the
        bottom)."""
        ch = int(channel_mult[0] * model_channels)
        blocks = nn.ModuleList([TimestepEmbedSequential([Conv2d(
            in_channels, ch, 3, padding=1, dtype=self.dtype, device=self.device)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [self(ch, int(mult * model_channels))]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(self.attn(ch, heads))
                blocks.append(TimestepEmbedSequential(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                blocks.append(TimestepEmbedSequential([self.down(ch)]))
                chans.append(ch)
                ds *= 2
        return blocks, chans, ch, ds


def _time_embed(model_channels: int, ted: int, device) -> nn.Sequential:
    return nn.Sequential(nn.Linear(model_channels, ted, device=device), nn.SiLU(),
                         nn.Linear(ted, ted, device=device))


class UNetModel(nn.Module):
    """The guided-diffusion UNet.  (reference: models/adm/unet.py:415-683)

    Keys are guided-diffusion's, so its released files load as they are.
    ``attention_resolutions`` are downsample factors (``ds``), as the
    reference's model factory passes them.  ``use_fp16`` (the release's
    fp16 torso) and ``torso_dtype`` give a bf16 torso; the embeddings, every
    GroupNorm, the softmax and the output head stay f32.  ``use_checkpoint``
    recomputes each ResBlock and attention block in the backward pass.
    """

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int, attention_resolutions: Sequence[int],
                 dropout: float = 0.0, channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_classes: Optional[int] = None,
                 num_heads: int = 1, num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 use_new_attention_order: bool = False, use_fp16: bool = False,
                 use_checkpoint: Any = False, torso_dtype=None, device=None):
        super().__init__()
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        dt = resolve_torso_dtype(torso_dtype, use_fp16)
        self.torso_dtype, self.in_channels, self.out_channels = dt, in_channels, out_channels
        self.model_channels, self.num_classes = model_channels, num_classes
        self.use_checkpoint = normalize_use_checkpoint(use_checkpoint)
        ted = model_channels * 4
        self.time_embed = _time_embed(model_channels, ted, device)
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ted, device=device)
        b = _BlockFactory(ted, dropout, use_scale_shift_norm, resblock_updown, conv_resample,
                     num_head_channels, use_new_attention_order, dt, device)
        self.input_blocks, chans, ch, ds = b.encoder(
            in_channels, model_channels, channel_mult, num_res_blocks, attention_resolutions,
            num_heads)
        self.middle_block = TimestepEmbedSequential([b(ch), b.attn(ch, num_heads), b(ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [b(ch + chans.pop(), int(mult * model_channels))]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(b.attn(ch, heads_up))
                if level and i == num_res_blocks:
                    layers.append(b.up(ch))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(layers))
        self.out = nn.Sequential(GroupNorm32(ch, device=device), nn.SiLU(),
                                 _zeros_conv(ch, out_channels, 3, device=device))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None, *, train: bool = False) -> torch.Tensor:
        """``train`` turns the ResBlocks' dropout on (the JAX module's keyword)."""
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        if self.num_classes is not None:
            if y is None:
                raise ValueError("class-conditional model requires y")
            emb = emb + self.label_emb(y.long())
        h, hs, remat = x, [], self.use_checkpoint
        for block in self.input_blocks:
            h = block(h, emb, None, remat, train)
            hs.append(h)
        h = self.middle_block(h, emb, None, remat, train)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, None, remat, train)
        return self.out[2](self.out[0](h.to(x.dtype), silu=True))


class SuperResModel(UNetModel):
    """A ``UNetModel`` conditioned on a low-resolution image, bilinearly
    upsampled and concatenated on the channels.  (reference:
    models/adm/unet.py:685-700)  Takes the reference's ``in_channels`` (the
    image's), doubled inside.  Its keys are the reference's (those of a
    ``UNetModel``); the JAX module holds them under ``unet``, which
    ``flax_rename`` strips."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int, attention_resolutions: Sequence[int],
                 kwargs: Optional[dict] = None, **extra: Any):
        super().__init__(image_size, in_channels * 2, model_channels, out_channels,
                         num_res_blocks, attention_resolutions, **dict(kwargs or {}, **extra))

    @staticmethod
    def flax_rename(key: str) -> str:
        return key[len("unet."):] if key.startswith("unet.") else key

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                low_res: Optional[torch.Tensor] = None, **kwargs: Any) -> torch.Tensor:
        up = F.interpolate(low_res, x.shape[2:], mode="bilinear", align_corners=False)
        return super().forward(torch.cat([x, up.to(x.dtype)], dim=1), timesteps, **kwargs)


class EncoderUNetModel(nn.Module):
    """The classifier half-UNet: the encoder and middle block of a
    ``UNetModel`` and a pooling head, ``pool`` "adaptive", "attention",
    "spatial" or "spatial_v2".  (reference: models/adm/unet.py:703-913)
    spatial_v2's GroupNorm of the 2048-vector runs the plain version (it is
    no image)."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int, attention_resolutions: Sequence[int],
                 dropout: float = 0.0, channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, num_heads: int = 1, num_head_channels: int = -1,
                 use_scale_shift_norm: bool = False, resblock_updown: bool = False,
                 use_new_attention_order: bool = False, use_fp16: bool = False,
                 use_checkpoint: Any = False, pool: str = "adaptive", torso_dtype=None,
                 device=None):
        super().__init__()
        dt = resolve_torso_dtype(torso_dtype, use_fp16)
        self.torso_dtype, self.model_channels, self.pool = dt, model_channels, pool
        self.use_checkpoint = normalize_use_checkpoint(use_checkpoint)
        ted = model_channels * 4
        self.time_embed = _time_embed(model_channels, ted, device)
        b = _BlockFactory(ted, dropout, use_scale_shift_norm, resblock_updown, conv_resample,
                     num_head_channels, use_new_attention_order, dt, device)
        self.input_blocks, chans, ch, ds = b.encoder(
            in_channels, model_channels, channel_mult, num_res_blocks, attention_resolutions,
            num_heads)
        self.middle_block = TimestepEmbedSequential([b(ch), b.attn(ch, num_heads), b(ch)])
        if pool == "adaptive":
            self.out = nn.Sequential(GroupNorm32(ch, device=device), nn.SiLU(),
                                     nn.AdaptiveAvgPool2d((1, 1)),
                                     _zeros_conv(ch, out_channels, 1, padding=0, device=device))
        elif pool == "attention":
            self.out = nn.Sequential(GroupNorm32(ch, device=device), nn.SiLU(), AttentionPool2d(
                image_size // ds, ch, num_head_channels, out_channels, dtype=dt, device=device))
        elif pool == "spatial":
            self.out = nn.Sequential(nn.Linear(sum(chans) + ch, 2048, device=device), nn.ReLU(),
                                     nn.Linear(2048, out_channels, device=device))
        elif pool == "spatial_v2":
            self.out = nn.Sequential(nn.Linear(sum(chans) + ch, 2048, device=device),
                                     GroupNorm32(2048, device=device), nn.SiLU(),
                                     nn.Linear(2048, out_channels, device=device))
        else:
            raise NotImplementedError(f"Unexpected {pool} pooling")

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, *,
                train: bool = False) -> torch.Tensor:
        """``train`` turns the ResBlocks' dropout on (the JAX module's keyword)."""
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels))
        spatial = self.pool.startswith("spatial")
        results, h, remat = [], x, self.use_checkpoint
        for block in self.input_blocks:
            h = block(h, emb, None, remat, train)
            if spatial:
                results.append(h.to(x.dtype).mean(dim=(2, 3)))
        h = self.middle_block(h, emb, None, remat, train)
        if spatial:
            results.append(h.to(x.dtype).mean(dim=(2, 3)))
            feats = self.out[0](torch.cat(results, dim=-1))
            if self.pool == "spatial":
                return self.out[2](F.relu(feats))
            gn = self.out[1]
            feats = group_norm_silu_reference(feats, gn.weight, gn.bias, 32, gn.eps, True)
            return self.out[3](feats)
        h = self.out[0](h.to(x.dtype), silu=True)
        if self.pool == "adaptive":
            return self.out[3](h.mean(dim=(2, 3), keepdim=True)).flatten(1)
        return self.out[2](h)


class UNetCombined(nn.Module):
    """The conditional and unconditional ADM UNets of classifier-free
    guidance in one module (reference: models/adm/unet_combined.py:6-32):
    ``unet_cond`` (``unet_kwargs`` with ``num_classes``) and ``unet_uncond``
    (without).  ``forward`` routes ``y=None`` to the unconditional UNet;
    ``forward_cfg`` takes the CFG samplers' doubled batch [cond | uncond].
    Two upstream files become one state dict through ``combine_state_dicts``."""

    def __init__(self, unet_kwargs: dict, device=None):
        super().__init__()
        kw = dict(unet_kwargs)
        if kw.get("num_classes") is None:
            raise ValueError("UNetCombined needs unet_kwargs['num_classes']")
        self.num_classes = kw["num_classes"]
        self.unet_cond = UNetModel(**kw, device=device)
        self.unet_uncond = UNetModel(**dict(kw, num_classes=None), device=device)
        self.in_channels = self.unet_cond.in_channels
        self.out_channels = self.unet_cond.out_channels

    @staticmethod
    def combine_state_dicts(cond_sd: Dict[str, torch.Tensor],
                            uncond_sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One state dict of this module from the two upstream ones (the
        torch side of ``dmtpu/convert/zoo.py::combine_adm_weights``)."""
        merged = {f"unet_cond.{k}": v for k, v in cond_sd.items()}
        merged.update({f"unet_uncond.{k}": v for k, v in uncond_sd.items()})
        return merged

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None, *, train: bool = False) -> torch.Tensor:
        if y is None:
            return self.unet_uncond(x, timesteps, train=train)
        return self.unet_cond(x, timesteps, y, train=train)

    def forward_cfg(self, x: torch.Tensor, timesteps: torch.Tensor, y: torch.Tensor, *,
                    train: bool = False) -> torch.Tensor:
        """The first half of the batch conditional (labels ``y``), the second
        unconditional."""
        b = x.shape[0] // 2
        return torch.cat([self.unet_cond(x[:b], timesteps[:b], y[:b], train=train),
                          self.unet_uncond(x[b:], timesteps[b:], train=train)], dim=0)
