"""MMDiT, the SD3-class multimodal diffusion transformer, in NCHW.

Counterpart of ``dmtpu/models/mmdit.py`` (Esser et al. 2024, "Scaling
Rectified Flow Transformers"): two token streams, text context and image
patches, with their own weights, which meet in ONE joint attention a block
(``dmtpu_torch.ops.attention.attention`` over S = L_ctx + L_img: K1 on the
card, the plain ``mha`` on the CPU).  The adaLN vector ``c = MLP(t_emb) +
MLP(pooled)`` modulates every block (adaLN-Zero, as DiT: zero-initialised
modulations make each block an identity at init); ``qk_norm`` adds the
per-head RMSNorm of q and k (f32, eps 1e-6).  The last block is
``context_pre_only``: its context stream makes only q, k and v for the
joint attention and has a 2 x hidden modulation, no projection, no MLP.

Module keys are SD3's upstream ones (``x_embedder.proj``,
``t_embedder.mlp.{0,2}``, ``y_embedder.mlp.{0,2}``, ``context_embedder``,
``joint_blocks.{i}.{x_block,context_block}.{adaLN_modulation.1, attn.qkv,
attn.proj, attn.ln_q, attn.ln_k, mlp.fc1, mlp.fc2}``,
``final_layer.{adaLN_modulation.1, linear}``), so an SD3 state dict loads
once its prefix and ``pos_embed`` are dropped
(``dmtpu_torch.convert.zoo.convert_mmdit``); the JAX package's params load
through the bridge's rename (``dmtpu_torch.convert.flax_bridge.mmdit_key``).

Torso dtype, as ``dmtpu_torch/models/dit.py``: the patch convolution, the
context embedder and the blocks compute in ``dtype`` (bf16 on the card,
where K1 takes bf16 only), the timestep and pooled MLPs in f32, the final
``linear`` in f32 unless ``dtype`` and ``param_dtype`` are both bf16.
``param_dtype`` (f32 when None) stores the torso's weights: the patch
convolution, the context embedder, every block's adaLN, qkv, proj and MLP,
and the final layer; ``param_dtype=bfloat16`` halves the memory of those
weights and their gradients (what SD3-medium's training config asks for).
The conditioning MLPs and the QK-RMSNorm scales stay f32, as in JAX.
``pos_embed_max_size`` reads the centre crop of the sin/cos table of that
base grid at ``offset = (ms - grid) // 2``, as a non-persistent buffer.
Conditioning is ``y = {"context": [B, L, Dc], "pooled": [B, Dp]}``;
``null_conditioning`` is the all-zeros pytree that the training dropout
also produces.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dmtpu_torch.convert.flax_bridge import mmdit_key
from dmtpu_torch.models.adm import Conv2d, Linear
from dmtpu_torch.models.dit import (
    FinalLayer,
    TimestepEmbedder,
    TimmMlp,
    ada_ln,
    get_2d_sincos_pos_embed,
    layer_norm,
    modulate,
    unpatchify,
)
from dmtpu_torch.models.ema import as_dtype
from dmtpu_torch.ops.attention import attention
from dmtpu_torch.ops.rematerialize import normalize_use_checkpoint, remat_call


class RMSNorm(nn.Module):
    """RMSNorm over the last axis with a learned scale, computed in f32 and
    returned in the input's dtype (the JAX package's ``_QKNorm`` half)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mul = torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps) * self.weight
        return (xf * mul).to(x.dtype)


class JointAttention(nn.Module):
    """One stream's side of the joint attention: ``qkv``, the optional
    ``ln_q`` / ``ln_k`` and, unless ``pre_only``, the output ``proj``."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool, pre_only: bool, dtype=None,
                 device=None, param_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype, device=device, param_dtype=param_dtype)
        if qk_norm:
            self.ln_q = RMSNorm(dim // num_heads, device=device)
            self.ln_k = RMSNorm(dim // num_heads, device=device)
        if not pre_only:
            self.proj = Linear(dim, dim, dtype=dtype, device=device, param_dtype=param_dtype)

    def qkv_heads(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[B, L, D] -> q, k, v [B, L, H, D / H], q and k normalised."""
        b, n, d = h.shape
        qkv = self.qkv(h).reshape(b, n, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.unbind(2)
        if hasattr(self, "ln_q"):
            q, k = self.ln_q(q), self.ln_k(k)
        return q, k, v


class StreamBlock(nn.Module):
    """The weights of one stream in a joint block (``x_block`` or
    ``context_block``): its modulation, attention side and MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qk_norm: bool,
                 pre_only: bool = False, dtype=None, device=None, param_dtype=None):
        super().__init__()
        self.pre_only = pre_only
        self.adaLN_modulation = ada_ln(dim, 2 if pre_only else 6, dtype, device, param_dtype)
        self.attn = JointAttention(dim, num_heads, qk_norm, pre_only, dtype, device, param_dtype)
        if not pre_only:
            self.mlp = TimmMlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device,
                               param_dtype=param_dtype)

    def pre_attention(self, tokens: torch.Tensor, c: torch.Tensor):
        """(q, k, v, the remaining modulation chunks) of this stream."""
        mod = self.adaLN_modulation(c).chunk(2 if self.pre_only else 6, dim=-1)
        q, k, v = self.attn.qkv_heads(modulate(layer_norm(tokens), mod[0], mod[1]))
        return q, k, v, mod[2:]

    def post_attention(self, tokens: torch.Tensor, att: torch.Tensor, mod) -> torch.Tensor:
        """The gated residuals (adaLN-Zero) of the attention and the MLP."""
        g_msa, s_mlp, sc_mlp, g_mlp = mod
        tokens = tokens + g_msa[:, None] * self.attn.proj(att)
        return tokens + g_mlp[:, None] * self.mlp(modulate(layer_norm(tokens), s_mlp, sc_mlp))


class MMDiTBlock(nn.Module):
    """One joint-attention block: separate context and image weights, ONE
    attention over the concatenated [context | image] tokens."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qk_norm: bool = True,
                 context_pre_only: bool = False, dtype=None, device=None, param_dtype=None):
        super().__init__()
        self.context_block = StreamBlock(dim, num_heads, mlp_ratio, qk_norm, context_pre_only,
                                         dtype, device, param_dtype)
        self.x_block = StreamBlock(dim, num_heads, mlp_ratio, qk_norm, False, dtype, device,
                                   param_dtype)

    def forward(self, ctx: torch.Tensor, x: torch.Tensor, c: torch.Tensor
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        b, lc, d = ctx.shape
        cq, ck, cv, c_mod = self.context_block.pre_attention(ctx, c)
        xq, xk, xv, x_mod = self.x_block.pre_attention(x, c)
        o = attention(torch.cat([cq, xq], 1), torch.cat([ck, xk], 1), torch.cat([cv, xv], 1))
        o = o.reshape(b, -1, d)
        x = self.x_block.post_attention(x, o[:, lc:], x_mod)
        if self.context_block.pre_only:
            return None, x
        return self.context_block.post_attention(ctx, o[:, :lc], c_mod), x


class MMDiT(nn.Module):
    """SD3-class rectified-flow transformer (``dmtpu.models.mmdit.MMDiT``);
    NCHW latents in, velocity out, ``model(x, t, y)``."""

    # the JAX package's params tree names its modules otherwise
    flax_rename = staticmethod(mmdit_key)

    def __init__(
        self,
        input_size: int = 32,
        patch_size: int = 2,
        in_channels: int = 4,
        hidden_size: int = 1536,
        depth: int = 24,
        num_heads: int = 24,
        mlp_ratio: float = 4.0,
        context_dim: int = 4096,
        pooled_dim: int = 2048,
        cond_dropout_prob: float = 0.1,
        qk_norm: bool = True,
        pos_embed_max_size: Optional[int] = None,
        use_checkpoint: Any = False,
        prefer_flash: bool = False,  # the JAX dispatch's switch; one dispatch here
        dtype: Any = None,
        param_dtype: Any = None,
        device=None,
    ):
        super().__init__()
        self.input_size, self.patch_size, self.in_channels = input_size, patch_size, in_channels
        self.hidden_size, self.depth, self.num_heads = hidden_size, depth, num_heads
        self.context_dim, self.pooled_dim = context_dim, pooled_dim
        self.cond_dropout_prob = float(cond_dropout_prob)
        self.qk_norm, self.pos_embed_max_size = bool(qk_norm), pos_embed_max_size
        self.use_checkpoint, self.remat_policy = normalize_use_checkpoint(use_checkpoint)
        self.dtype, self.param_dtype = as_dtype(dtype), as_dtype(param_dtype)
        p, dt, pdt = patch_size, self.dtype, self.param_dtype
        self.x_embedder = nn.Module()
        self.x_embedder.proj = Conv2d(in_channels, hidden_size, p, stride=p, dtype=dt,
                                      device=device, param_dtype=pdt)
        self.t_embedder = TimestepEmbedder(hidden_size, device=device)
        self.y_embedder = nn.Module()  # the pooled text vector's MLP, f32
        self.y_embedder.mlp = nn.Sequential(Linear(pooled_dim, hidden_size, device=device),
                                            nn.SiLU(), Linear(hidden_size, hidden_size,
                                                              device=device))
        self.context_embedder = Linear(context_dim, hidden_size, dtype=dt, device=device,
                                       param_dtype=pdt)
        self.joint_blocks = nn.ModuleList([
            MMDiTBlock(hidden_size, num_heads, mlp_ratio, qk_norm, i == depth - 1, dt, device,
                       pdt)
            for i in range(depth)])
        self.final_layer = FinalLayer(hidden_size, p, in_channels, dtype=dt, device=device,
                                      param_dtype=pdt)
        self.register_buffer("pos_embed", self._pos_embed(device), persistent=False)

    @property
    def grid(self) -> int:
        return self.input_size // self.patch_size

    def _pos_embed(self, device) -> torch.Tensor:
        """[1, grid**2, D] f32: the table of this grid, or with
        ``pos_embed_max_size`` the centre crop of the base grid's table
        (SD3's cropped_pos_embed), built for the window alone."""
        grid, offset = self.grid, 0
        if self.pos_embed_max_size is not None:
            ms = self.pos_embed_max_size
            if grid > ms:
                raise ValueError(f"input grid {grid} exceeds pos_embed_max_size {ms}")
            offset = (ms - grid) // 2
        table = get_2d_sincos_pos_embed(self.hidden_size, grid, offset=offset)
        return torch.from_numpy(table[None].astype(np.float32)).to(device)

    def null_conditioning(self, batch: int, context_len: int, dtype=torch.float32,
                          device=None) -> Dict[str, torch.Tensor]:
        """The all-zeros conditioning pytree (the unconditional branch, and what
        the training dropout gives), at this model's widths."""
        return {"context": torch.zeros(batch, context_len, self.context_dim, dtype=dtype,
                                       device=device),
                "pooled": torch.zeros(batch, self.pooled_dim, dtype=dtype, device=device)}

    def _condition(self, t: torch.Tensor, y: Dict[str, torch.Tensor], *, train: bool,
                   drop_generator: Optional[torch.Generator]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context tokens, adaLN vector c); with ``train`` and a generator,
        each sample's conditioning is zeroed with ``cond_dropout_prob``."""
        context, pooled = y["context"], y["pooled"]
        if train and self.cond_dropout_prob > 0 and drop_generator is not None:
            drop = torch.rand(context.shape[0], generator=drop_generator,
                              device=context.device) < self.cond_dropout_prob
            context = torch.where(drop[:, None, None], 0.0, context)
            pooled = torch.where(drop[:, None], 0.0, pooled)
        c = self.t_embedder(t) + self.y_embedder.mlp(pooled)
        return self.context_embedder(context), c

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[Dict[str, torch.Tensor]] = None, *, train: bool = False,
                drop_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if y is None:
            raise ValueError("MMDiT needs y={'context': [B, L, Dc], 'pooled': [B, Dp]}; for the "
                             "unconditional branch pass model.null_conditioning(...)")
        # a config-vs-data width check (the linear layers would fail deep inside)
        if y["context"].shape[-1] != self.context_dim or y["pooled"].shape[-1] != self.pooled_dim:
            raise ValueError(
                f"conditioning widths {y['context'].shape[-1]}/{y['pooled'].shape[-1]} do not "
                f"match the model's context_dim={self.context_dim}/pooled_dim={self.pooled_dim}")
        tokens = self.x_embedder.proj(x).flatten(2).transpose(1, 2)  # [B, T, D], (h, w) order
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        ctx, c = self._condition(t, y, train=train, drop_generator=drop_generator)
        for blk in self.joint_blocks:
            ctx, tokens = (remat_call(blk, ctx, tokens, c, policy=self.remat_policy)
                           if self.use_checkpoint
                           else blk(ctx, tokens, c))
        return unpatchify(self.final_layer(tokens, c), self.grid, self.patch_size,
                          self.in_channels)


# SD3's scaling rule: hidden = 64 x depth, heads = depth (so head dim 64);
# MMDiT-L/2 at depth 24 is SD3-medium's 2B configuration
MMDIT_CONFIGS = {
    "MMDiT-S/2": dict(depth=6, hidden_size=384, patch_size=2, num_heads=6),
    "MMDiT-B/2": dict(depth=12, hidden_size=768, patch_size=2, num_heads=12),
    "MMDiT-L/2": dict(depth=24, hidden_size=1536, patch_size=2, num_heads=24),
    "MMDiT-XL/2": dict(depth=38, hidden_size=2432, patch_size=2, num_heads=38),
}


def mmdit_model(name: str, **kwargs: Any) -> MMDiT:
    return MMDiT(**{**MMDIT_CONFIGS[name], **kwargs})
