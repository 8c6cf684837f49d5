"""sail-sg MDTv2 (Masked Diffusion Transformer), in NCHW.

Counterpart of ``dmtpu/models/mdt.py`` (reference: models/mdt/model.py):
relative-position-bias attention, the encoder / decoder split with skip
links, masked latent modelling (``random_masking`` and the side
interpolater) and the power-cosine timestep-dependent guidance scale of
``forward_with_cfg``.  Module keys are the upstream ones
(``en_inblocks.N``, ``en_outblocks.N.skip_linear``, ``sideblocks.0``,
``de_blocks.N``, ``attn.rel_pos_bias.relative_position_bias_table``,
``pos_embed``, ``decoder_pos_embed``, ``mask_token``); the
``relative_position_index`` buffers are rebuilt, not loaded.

Masked training takes a static keep-length, as the JAX module does:
``sample_len_keep`` snaps the reference's continuous mask ratio to a few
lengths, and the mask is drawn from an explicit ``torch.Generator``.

The attention adds a per-head relative-position bias to the logits, which no
kernel of this package takes: as in the JAX package, which computes this
attention outside any Pallas kernel, it is plain PyTorch here (f32 logits and
softmax) on every device, and K1 is not launched for it.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dmtpu_torch.models.adm import Conv2d, Linear
from dmtpu_torch.models.dit import (
    FinalLayer,
    LabelEmbedder,
    TimestepEmbedder,
    TimmMlp,
    ada_ln,
    class_dropout,
    layer_norm,
    modulate,
    pos_embed_buffer,
    unpatchify,
)
from dmtpu_torch.models.ema import as_dtype
from dmtpu_torch.ops.rematerialize import normalize_use_checkpoint, remat_call


def sample_len_keep(num_patches: int, mask_ratio: float, u: float, n_buckets: int = 8) -> int:
    """Bucketed masked-training keep-length.

    The reference draws a continuous ratio ``r ~ U[mask_ratio, mask_ratio +
    0.2]`` per step and keeps ``int(L (1 - r))`` tokens (reference:
    models/mdt/model.py:463-467, 390-397); the ratio is snapped to
    ``n_buckets`` evenly spaced keep-lengths over the same range, as the JAX
    package does.  ``u`` is a uniform draw in [0, 1)."""
    # epsilon guard: 1 - 0.3 - 0.2 = 0.4999... in binary would put lo one
    # token below the reference distribution's support
    lo = int(np.floor(num_patches * (1 - mask_ratio - 0.2) + 1e-6))
    hi = int(np.floor(num_patches * (1 - mask_ratio) + 1e-6))
    buckets = np.unique(np.linspace(lo, hi, n_buckets).round().astype(int))
    target = num_patches * (1 - (mask_ratio + 0.2 * float(u)))
    return int(buckets[np.argmin(np.abs(buckets - target))])


def _relative_position_index(grid: int) -> np.ndarray:
    """BEiT-style pairwise relative position index, [T, T]
    (reference: models/mdt/model.py:61-99)."""
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += grid - 1
    rel[:, :, 1] += grid - 1
    rel[:, :, 0] *= 2 * grid - 1
    return rel.sum(-1)


class RelativePositionBias(nn.Module):
    """``rel_pos_bias``: the per-head table and its (rebuilt) index."""

    def __init__(self, grid: int, num_heads: int, device=None):
        super().__init__()
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * grid - 1) ** 2 + 3, num_heads, device=device))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_relative_position_index(grid)).to(device),
                             persistent=False)

    def forward(self) -> torch.Tensor:
        """The bias as [H, T, T]."""
        t = self.relative_position_index.shape[0]
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        return bias.reshape(t, t, -1).permute(2, 0, 1)


class RelPosAttention(nn.Module):
    """MDT attention with relative position bias (reference: models/mdt/model.py:13-58).

    Plain PyTorch on every device (see the module's docstring): q k^T * scale
    in f32, the bias added, an f32 softmax, the weights cast to v's dtype."""

    def __init__(self, dim: int, num_heads: int, num_patches: int, dtype=None, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)
        self.rel_pos_bias = RelativePositionBias(int(num_patches ** 0.5), num_heads, device)

    def forward(self, x: torch.Tensor, ids_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, d = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(b, t, 3, heads, d // heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        bias = self.rel_pos_bias()  # [H, T, T]
        if ids_keep is not None:
            # the kept rows and columns of each sample: [B, H, keep, keep]
            bias = bias[None].expand(b, -1, -1, -1)
            idx = ids_keep[:, None, :, None].expand(-1, heads, -1, bias.shape[-1])
            bias = torch.gather(bias, 2, idx)
            idx = ids_keep[:, None, None, :].expand(-1, heads, bias.shape[2], -1)
            bias = torch.gather(bias, 3, idx)
        else:
            bias = bias[None]
        scale = (d // heads) ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
        w = torch.softmax(logits + bias.float(), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v).reshape(b, t, d)
        return self.proj(out)


class MDTBlock(nn.Module):
    """(reference: models/mdt/model.py:187-221); ``skip`` adds the
    ``skip_linear`` over [x, skip]."""

    def __init__(self, dim: int, num_heads: int, num_patches: int, mlp_ratio: float = 4.0,
                 skip: bool = False, dtype=None, device=None):
        super().__init__()
        # the skip projection has no dtype in the JAX module: it computes in f32
        self.skip_linear = Linear(2 * dim, dim, device=device) if skip else None
        self.attn = RelPosAttention(dim, num_heads, num_patches, dtype=dtype, device=device)
        self.mlp = TimmMlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.adaLN_modulation = ada_ln(dim, 6, dtype, device)

    def forward(self, x: torch.Tensor, c: torch.Tensor, skip: Optional[torch.Tensor] = None,
                ids_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.skip_linear is not None:
            x = self.skip_linear(torch.cat([x, skip], dim=-1))
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + g_msa[:, None] * self.attn(modulate(layer_norm(x), s_msa, sc_msa),
                                           ids_keep=ids_keep)
        return x + g_mlp[:, None] * self.mlp(modulate(layer_norm(x), s_mlp, sc_mlp))


def _uniform(shape: Tuple[int, ...], generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def random_masking(x: torch.Tensor, len_keep: int, generator: Optional[torch.Generator]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-length variant of reference :390-417: (x_masked, mask,
    ids_restore, ids_keep), the permutation drawn from ``generator``."""
    n, length, d = x.shape
    noise = _uniform((n, length), generator, x.device)
    ids_shuffle = torch.argsort(noise, dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, d))
    mask = torch.ones(n, length, device=x.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return x_masked, mask, ids_restore, ids_keep


class MDTv2(nn.Module):
    """(reference: models/mdt/model.py:246-527); NCHW in and out."""

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
        mask_ratio: Optional[float] = None,
        decode_layer: int = 4,
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
        self.mask_ratio, self.decode_layer = mask_ratio, decode_layer
        self.use_checkpoint, self.remat_policy = normalize_use_checkpoint(use_checkpoint)
        self.dtype = dt = as_dtype(dtype)
        p, t = patch_size, self.num_patches
        half = (depth - decode_layer) // 2
        self.x_embedder = nn.Module()
        self.x_embedder.proj = Conv2d(in_channels, hidden_size, p, stride=p, dtype=dt,
                                      device=device)
        self.t_embedder = TimestepEmbedder(hidden_size, device=device)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size, self.class_dropout_prob,
                                        device=device)
        self.pos_embed = nn.Parameter(pos_embed_buffer(hidden_size, self.grid, device))
        self.decoder_pos_embed = nn.Parameter(pos_embed_buffer(hidden_size, self.grid, device))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, hidden_size, device=device))
        if mask_ratio is not None:
            nn.init.trunc_normal_(self.mask_token, std=0.02)

        def block(skip=False):
            return MDTBlock(hidden_size, num_heads, t, mlp_ratio, skip=skip, dtype=dt,
                            device=device)

        self.en_inblocks = nn.ModuleList([block() for _ in range(half)])
        self.en_outblocks = nn.ModuleList([block(skip=True) for _ in range(half)])
        self.sideblocks = nn.ModuleList([block()])
        self.de_blocks = nn.ModuleList([block(skip=True) for _ in range(decode_layer)])
        self.final_layer = FinalLayer(hidden_size, p, self.out_channels, dtype=dt, device=device)

    @property
    def grid(self) -> int:
        return self.input_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid ** 2

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None, *,
                enable_mask: bool = False, len_keep: Optional[int] = None,
                mask_generator: Optional[torch.Generator] = None, train: bool = False,
                drop_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The denoiser.  With ``enable_mask`` (and a ``mask_ratio``), only
        ``len_keep`` tokens, drawn from ``mask_generator``, go through the
        encoder, and the side interpolater fills in the rest."""
        b = x.shape[0]
        if y is None:
            y = torch.full((b,), self.num_classes, dtype=torch.int64, device=x.device)
        tokens = self.x_embedder.proj(x).flatten(2).transpose(1, 2)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        y = torch.as_tensor(y, device=x.device).long()
        if train and self.class_dropout_prob > 0 and drop_generator is not None:
            y = class_dropout(y, self.class_dropout_prob, self.num_classes, drop_generator)
        c = self.t_embedder(t) + self.y_embedder(y)

        def run(blk, z, skip=None, ids_keep=None):
            if self.use_checkpoint:
                return remat_call(blk, z, c, skip, ids_keep, policy=self.remat_policy)
            return blk(z, c, skip=skip, ids_keep=ids_keep)

        masked = self.mask_ratio is not None and enable_mask
        xx, ids_keep = tokens, None
        if masked:
            if len_keep is None:
                raise ValueError("enable_mask needs len_keep (sample_len_keep)")
            xx, mask, ids_restore, ids_keep = random_masking(xx, len_keep, mask_generator)
        skips = []
        for blk in self.en_inblocks:
            xx = run(blk, xx, ids_keep=ids_keep)
            skips.append(xx)
        for blk in self.en_outblocks:
            xx = run(blk, xx, skip=skips.pop(), ids_keep=ids_keep)
        if masked:
            # side interpolater (reference :419-438)
            n_masked = self.num_patches - xx.shape[1]
            # the f32 token and the stream promote as in the JAX module
            xx = torch.cat([xx, self.mask_token.expand(b, n_masked, -1)], dim=1)
            xx = torch.gather(xx, 1, ids_restore[:, :, None].expand(-1, -1, xx.shape[-1]))
            xx = xx + self.decoder_pos_embed.to(xx.dtype)
            before = xx
            xx = self.sideblocks[0](xx, c)
            m = mask[:, :, None]
            xx = xx * m + (1 - m) * before
        else:
            xx = xx + self.decoder_pos_embed.to(xx.dtype)
        for blk in self.de_blocks:
            xx = run(blk, xx, skip=tokens)
        return unpatchify(self.final_layer(xx, c), self.grid, self.patch_size, self.out_channels)

    def load_upstream(self, state_dict: Mapping[str, Any], strict: bool = True) -> "MDTv2":
        """Load an upstream MDTv2 state dict; the ``relative_position_index``
        buffers, which this module rebuilds, are dropped (as ``convert_mdt``
        drops them)."""
        self.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()
                              if not k.endswith("relative_position_index")}, strict=strict)
        return self

    def forward_with_cfg(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                         cfg_scale: Optional[float] = None, diffusion_steps: int = 1000,
                         scale_pow: float = 4.0) -> torch.Tensor:
        """Power-cosine-scaled guidance on the first 3 channels (reference:
        models/mdt/model.py:503-527): the scale rises from 1 at t = T to
        ``cfg_scale`` at t = 0.  ``cfg_scale=None`` is the plain forward."""
        if cfg_scale is None:
            return self(x, t, y)
        n = x.shape[0] // 2
        half = x[:n]
        model_out = self(torch.cat([half, half]), t, y)
        eps, rest = model_out[:, :3], model_out[:, 3:]
        cond_eps, uncond_eps = eps.chunk(2)
        tt = torch.as_tensor(t, device=x.device).float()
        scale_step = (1 - torch.cos(((1 - tt / diffusion_steps) ** scale_pow) * math.pi)) / 2
        real = ((cfg_scale - 1) * scale_step + 1)[:n].reshape(-1, 1, 1, 1)
        half_eps = uncond_eps + real * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([half_eps, half_eps]), rest], dim=1)
