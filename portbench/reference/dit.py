"""DiT (Peebles & Xie, arXiv:2212.09748; facebookresearch/DiT ``models.py``)
in plain PyTorch, float32.

adaLN-Zero blocks over patch tokens with the fixed 2-D sin/cos position
table, timm's attention (one fused ``qkv``) and tanh-GELU MLP, the label
table with its null row for classifier-free guidance.  Parameter names are
the upstream ones (``x_embedder.proj``, ``t_embedder.mlp.0``,
``y_embedder.embedding_table``, ``blocks.N.attn.qkv``,
``blocks.N.adaLN_modulation.1``, ``final_layer.linear``), with
``pos_embed`` rebuilt here rather than loaded.  ``learn_sigma=False`` gives
the output head as many channels as the input.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.nn import Attend, Conv2d, Linear, timestep_embedding


def sincos_2d(dim: int, grid: int) -> torch.Tensor:
    """[grid**2, dim] position table in (h, w) order (upstream
    ``get_2d_sincos_pos_embed``)."""

    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    coords = np.arange(grid, dtype=np.float32)
    mesh = np.stack(np.meshgrid(coords, coords), axis=0).reshape(2, 1, grid, grid)
    table = np.concatenate([one_d(dim // 2, mesh[0]), one_d(dim // 2, mesh[1])], axis=1)
    return torch.from_numpy(table.astype(np.float32))


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.heads = heads
        self.attn = nn.Module()
        self.attn.qkv, self.attn.proj = Linear(dim, 3 * dim), Linear(dim, dim)
        self.mlp = nn.Module()
        hidden = int(dim * mlp_ratio)
        self.mlp.fc1, self.mlp.fc2 = Linear(dim, hidden), Linear(hidden, dim)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(dim, 6 * dim))
        self.attend = Attend()

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        mods = self.adaLN_modulation[1](F.silu(c)).chunk(6, dim=-1)
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = mods
        h = _modulate(_layer_norm(x), s_msa, sc_msa)
        q, k, v = self.attn.qkv(h).reshape(b, t, 3, self.heads, d // self.heads).unbind(2)
        x = x + g_msa[:, None] * self.attn.proj(self.attend(q, k, v).reshape(b, t, d))
        h = _modulate(_layer_norm(x), s_mlp, sc_mlp)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(h), approximate="tanh"))
        return x + g_mlp[:, None] * h


class DiT(nn.Module):
    def __init__(self, input_size: int, patch_size: int, in_channels: int, hidden_size: int,
                 depth: int, num_heads: int, mlp_ratio: float = 4.0, num_classes: int = 1000,
                 class_dropout_prob: float = 0.1, learn_sigma: bool = True, **_):
        super().__init__()
        self.p, self.grid = patch_size, input_size // patch_size
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.freq_dim = 256
        self.x_embedder = nn.Module()
        self.x_embedder.proj = Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)
        self.t_embedder = nn.Module()
        self.t_embedder.mlp = nn.Sequential(Linear(256, hidden_size), nn.SiLU(),
                                            Linear(hidden_size, hidden_size))
        self.y_embedder = nn.Module()
        self.y_embedder.embedding_table = nn.Embedding(
            num_classes + int(class_dropout_prob > 0), hidden_size)
        self.blocks = nn.ModuleList(Block(hidden_size, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.final_layer = nn.Module()
        self.final_layer.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                                          Linear(hidden_size, 2 * hidden_size))
        self.final_layer.linear = Linear(hidden_size, patch_size ** 2 * self.out_channels)
        self.hidden_size = hidden_size
        self._pos = None  # the position table, made on the input's device

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self._pos is None or self._pos.device != x.device:
            self._pos = sincos_2d(self.hidden_size, self.grid)[None].to(x.device)
        x = self.x_embedder.proj(x.float()).flatten(2).transpose(1, 2) + self._pos
        c = self.t_embedder.mlp(timestep_embedding(t, self.freq_dim))
        c = c + self.y_embedder.embedding_table(y.long())
        for block in self.blocks:
            x = block(x, c)
        fl = self.final_layer
        shift, scale = fl.adaLN_modulation[1](F.silu(c)).chunk(2, dim=-1)
        x = fl.linear(_modulate(_layer_norm(x), shift, scale))
        b, g, p, ch = x.shape[0], self.grid, self.p, self.out_channels
        x = x.reshape(b, g, g, p, p, ch)
        return torch.einsum("nhwpqc->nchpwq", x).reshape(b, ch, g * p, g * p)
