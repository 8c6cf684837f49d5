"""Meta DiT (Diffusion Transformer), in NCHW.

Counterpart of ``dmtpu/models/dit.py`` (reference: models/dit/model.py):
patchify ViT with adaLN-Zero blocks, a learned-sigma output of twice the
input channels, the frozen 2-D sin/cos positional embedding, the null-class
row of the label table and ``forward_with_cfg``'s first-3-channels guidance.
Module keys are the upstream ones (``x_embedder.proj``, ``t_embedder.mlp.0``,
``y_embedder.embedding_table``, ``blocks.N.attn.qkv``,
``blocks.N.adaLN_modulation.1``, ``final_layer.linear``), so an upstream
state dict loads once its ``pos_embed`` is dropped (``load_upstream``): here
the table is a non-persistent buffer that each module builds for itself.

Images are NCHW in and out; tokens are [B, T, D] in the upstream row-major
(h, w) order, and attention is ``dmtpu_torch.ops.attention.attention``
([B, S, H, D]: K1 on the card, the plain ``mha`` on the CPU).

Torso dtype: as in ``dmtpu_torch/models/adm.py``, parameters are f32 and the
patch embedding, the blocks' dense layers and the adaLN projections compute
in ``dtype`` (the JAX module's field; bf16 on the card), so the residual
stream is in ``dtype`` as the Flax module's is.  The timestep and label
embeddings and the final ``linear`` compute in f32, LayerNorm takes its
statistics in f32.  K1 takes bf16 only: an f32 DiT on the card fails at its
dtype check rather than casting.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dmtpu_torch.models.adm import Conv2d, Linear, timestep_embedding
from dmtpu_torch.models.ema import as_dtype
from dmtpu_torch.ops.attention import attention
from dmtpu_torch.ops.rematerialize import normalize_use_checkpoint, remat_call


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, offset: int = 0) -> np.ndarray:
    """[grid_size**2, embed_dim] float64 sin/cos table, rows in (h, w) order
    (reference: models/dit/model.py:276-325).  ``offset`` shifts both axes to
    positions [offset, offset + grid_size): the centre crop of a larger base
    table without building it.  A new array on every call: callers own it."""

    def get_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(offset, offset + grid_size, dtype=np.float32)
    grid_w = np.arange(offset, offset + grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = get_1d(embed_dim // 2, grid[0])
    emb_w = get_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def pos_embed_buffer(embed_dim: int, grid_size: int, device=None) -> torch.Tensor:
    """The sin/cos table as a [1, T, D] f32 tensor (for a module's buffer)."""
    table = get_2d_sincos_pos_embed(embed_dim, grid_size)[None].astype(np.float32)
    return torch.from_numpy(table).to(device)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None]) + shift[:, None]


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine parameters, statistics in f32, the result in
    ``x``'s dtype (Flax ``LayerNorm(use_bias=False, use_scale=False)``)."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


def unpatchify(tokens: torch.Tensor, grid: int, p: int, channels: int) -> torch.Tensor:
    """[B, grid**2, p*p*C] tokens -> [B, C, grid*p, grid*p]."""
    b = tokens.shape[0]
    out = tokens.reshape(b, grid, grid, p, p, channels)
    return torch.einsum("nhwpqc->nchpwq", out).reshape(b, channels, grid * p, grid * p)


class TimmAttention(nn.Module):
    """timm ``Attention`` (one fused ``qkv`` projection, then ``proj``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, dtype=None,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype, device=device)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.num_heads, d // self.num_heads)
        # q, k and v are strided views of the projection: K1 reads them in place
        out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return self.proj(out.reshape(b, t, d))


class TimmMlp(nn.Module):
    """timm ``Mlp``: fc1 -> GELU (tanh approximation) -> fc2; weights stored
    in ``param_dtype`` (f32 when None)."""

    def __init__(self, dim: int, hidden: int, dtype=None, device=None, param_dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype, device=device, param_dtype=param_dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype, device=device, param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def ada_ln(dim: int, n: int, dtype, device, param_dtype=None) -> nn.Sequential:
    """``adaLN_modulation`` = (SiLU, Linear to n * dim), zero-initialised."""
    lin = Linear(dim, n * dim, dtype=dtype, device=device, param_dtype=param_dtype)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return nn.Sequential(nn.SiLU(), lin)


class DiTBlock(nn.Module):
    """adaLN-Zero block (reference: models/dit/model.py:101-122)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, dtype=None,
                 device=None):
        super().__init__()
        self.attn = TimmAttention(dim, num_heads, dtype=dtype, device=device)
        self.mlp = TimmMlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.adaLN_modulation = ada_ln(dim, 6, dtype, device)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + g_msa[:, None] * self.attn(modulate(layer_norm(x), s_msa, sc_msa))
        return x + g_mlp[:, None] * self.mlp(modulate(layer_norm(x), s_mlp, sc_mlp))


class FinalLayer(nn.Module):
    """(reference: models/dit/model.py:125-142).  ``linear`` has no ``dtype``
    in the JAX module, so it computes in the promotion of its input's and
    its weights' dtypes: f32, or ``dtype`` when both that and
    ``param_dtype`` are bf16."""

    def __init__(self, dim: int, patch_size: int, out_channels: int, dtype=None, device=None,
                 param_dtype=None):
        super().__init__()
        self.adaLN_modulation = ada_ln(dim, 2, dtype, device, param_dtype)
        self.linear = Linear(dim, patch_size * patch_size * out_channels, device=device,
                             dtype=torch.promote_types(dtype or torch.float32,
                                                       param_dtype or torch.float32),
                             param_dtype=param_dtype)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(layer_norm(x), shift, scale))


class TimestepEmbedder(nn.Module):
    """``t_embedder``: the 256-wide cos-first embedding -> Linear, SiLU, Linear (f32)."""

    def __init__(self, hidden: int, freq_dim: int = 256, device=None):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(Linear(freq_dim, hidden, device=device), nn.SiLU(),
                                 Linear(hidden, hidden, device=device))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, self.freq_dim))


class LabelEmbedder(nn.Module):
    """``y_embedder``: the label table, with the null-class row ``num_classes``
    when classifier-free dropout is configured."""

    def __init__(self, num_classes: int, hidden: int, dropout_prob: float, device=None):
        super().__init__()
        self.embedding_table = nn.Embedding(num_classes + (1 if dropout_prob > 0 else 0), hidden,
                                            device=device)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.embedding_table(y)


def class_dropout(y: torch.Tensor, prob: float, null: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """``y`` with each label replaced by ``null`` with probability ``prob``,
    drawn from ``generator`` (classifier-free dropout in training)."""
    drop = torch.rand(y.shape, generator=generator, device=y.device) < prob
    return torch.where(drop, torch.full_like(y, null), y)


class DiT(nn.Module):
    """(reference: models/dit/model.py:145-270); NCHW in and out."""

    def __init__(
        self,
        input_size: int = 32,
        patch_size: int = 2,
        in_channels: int = 4,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        class_dropout_prob: float = 0.1,
        num_classes: int = 1000,
        learn_sigma: bool = True,
        use_checkpoint: Any = False,
        dtype: Any = None,
        device=None,
        **_: Any,
    ):
        super().__init__()
        self.input_size, self.patch_size, self.in_channels = input_size, patch_size, in_channels
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.class_dropout_prob, self.num_classes = float(class_dropout_prob), num_classes
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.use_checkpoint, self.remat_policy = normalize_use_checkpoint(use_checkpoint)
        self.dtype = as_dtype(dtype)
        p, dt = patch_size, self.dtype
        self.x_embedder = nn.Module()
        self.x_embedder.proj = Conv2d(in_channels, hidden_size, p, stride=p, dtype=dt,
                                      device=device)
        self.t_embedder = TimestepEmbedder(hidden_size, device=device)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size, self.class_dropout_prob,
                                        device=device)
        self.blocks = nn.ModuleList([DiTBlock(hidden_size, num_heads, mlp_ratio, dtype=dt,
                                              device=device) for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, p, self.out_channels, dtype=dt, device=device)
        self.register_buffer("pos_embed", pos_embed_buffer(hidden_size, self.grid, device),
                             persistent=False)

    @property
    def grid(self) -> int:
        return self.input_size // self.patch_size

    def embed(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None, *,
              train: bool = False, drop_generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Patchify + pos embed + (t, y) conditioning -> (tokens, c).
        ``drop_generator`` draws the classifier-free label dropout when
        ``train`` is set."""
        b = x.shape[0]
        if y is None:
            if self.class_dropout_prob <= 0:
                # the table has its null row (index num_classes) only with CFG
                # dropout; without it the lookup would read past the classes
                raise ValueError(
                    "unconditional forward (y=None) needs the null-label row: "
                    "construct DiT with class_dropout_prob > 0")
            y = torch.full((b,), self.num_classes, dtype=torch.int64, device=x.device)
        tokens = self.x_embedder.proj(x).flatten(2).transpose(1, 2)  # [B, T, D], (h, w) order
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        y = torch.as_tensor(y, device=x.device).long()
        if train and self.class_dropout_prob > 0 and drop_generator is not None:
            y = class_dropout(y, self.class_dropout_prob, self.num_classes, drop_generator)
        return tokens, self.t_embedder(t) + self.y_embedder(y)

    def head(self, tokens: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """FinalLayer + unpatchify -> NCHW."""
        return unpatchify(self.final_layer(tokens, c), self.grid, self.patch_size,
                          self.out_channels)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                train: bool = False, drop_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        tokens, c = self.embed(x, t, y, train=train, drop_generator=drop_generator)
        for blk in self.blocks:
            tokens = (remat_call(blk, tokens, c, policy=self.remat_policy) if self.use_checkpoint
                      else blk(tokens, c))
        return self.head(tokens, c)

    def load_upstream(self, state_dict: Mapping[str, Any], strict: bool = True) -> "DiT":
        """Load an upstream DiT state dict; its frozen ``pos_embed``, which this
        module builds itself, is dropped (as ``convert_dit`` drops it)."""
        self.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()
                              if k != "pos_embed"}, strict=strict)
        return self

    def forward_with_cfg(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                         cfg_scale: float) -> torch.Tensor:
        """Guidance on the first 3 channels (reference: models/dit/model.py:254-270):
        ``x`` is [cond half | uncond half] and ``y`` the labels of both."""
        half = x[: x.shape[0] // 2]
        model_out = self(torch.cat([half, half]), t, y)
        eps, rest = model_out[:, :3], model_out[:, 3:]
        cond_eps, uncond_eps = eps.chunk(2)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([half_eps, half_eps]), rest], dim=1)


# size configs (reference: models/dit/model.py:332-385)
DIT_CONFIGS = {
    "DiT-XL/2": dict(depth=28, hidden_size=1152, patch_size=2, num_heads=16),
    "DiT-XL/4": dict(depth=28, hidden_size=1152, patch_size=4, num_heads=16),
    "DiT-XL/8": dict(depth=28, hidden_size=1152, patch_size=8, num_heads=16),
    "DiT-L/2": dict(depth=24, hidden_size=1024, patch_size=2, num_heads=16),
    "DiT-L/4": dict(depth=24, hidden_size=1024, patch_size=4, num_heads=16),
    "DiT-L/8": dict(depth=24, hidden_size=1024, patch_size=8, num_heads=16),
    "DiT-B/2": dict(depth=12, hidden_size=768, patch_size=2, num_heads=12),
    "DiT-B/4": dict(depth=12, hidden_size=768, patch_size=4, num_heads=12),
    "DiT-B/8": dict(depth=12, hidden_size=768, patch_size=8, num_heads=12),
    "DiT-S/2": dict(depth=12, hidden_size=384, patch_size=2, num_heads=6),
    "DiT-S/4": dict(depth=12, hidden_size=384, patch_size=4, num_heads=6),
    "DiT-S/8": dict(depth=12, hidden_size=384, patch_size=8, num_heads=6),
}


def dit_model(name: str, **kwargs: Any) -> DiT:
    return DiT(**{**DIT_CONFIGS[name], **kwargs})
