"""Swin Transformer V2 multi-scale detection backbone, port of
`pl_yolo_tpu/models/backbones/swinv2.py`.

The three V2 changes over V1 (`swin.py`, whose windows, shift mask, patch
merging and stage loop it shares):

  * post-normalization: residual = x + norm(f(x));
  * scaled cosine attention with a learned per-head temperature
    (`logit_scale`, clamped at log 100);
  * a continuous relative position bias: a 2-layer MLP over the log-spaced
    coordinate table, squashed through 16·sigmoid, in place of a table.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...layers.blocks import LayerNorm
from ...layers.drops import DropPath
from ...ops.constant import array_constant
from .swin import (SwinTransformer, _gelu, add_window_mask, cyclic_windows,
                   relative_position_index)


def log_cpb_table(ws: int) -> np.ndarray:
    """Log-spaced relative coordinates [(2ws-1)², 2] in [-1, 1], fp32 (the
    JAX package computes them in float64, then casts)."""
    rng = np.arange(-(ws - 1), ws, dtype=np.float32)
    coords = np.stack(np.meshgrid(rng, rng, indexing="ij"), -1)
    coords = coords / max(ws - 1, 1) * 8.0
    coords = np.sign(coords) * np.log2(np.abs(coords) + 1.0) / np.log2(8.0)
    return coords.reshape(-1, 2).astype(np.float32)


class WindowAttentionV2(nn.Module):
    """Scaled-cosine window MSA with the continuous position bias; the qkv
    projection has no bias, q and v take their own (k none)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(num_heads, hd))
            self.v_bias = nn.Parameter(torch.zeros(num_heads, hd))
        else:
            self.q_bias = self.v_bias = None
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_fc1 = nn.Linear(2, 512)
        self.cpb_fc2 = nn.Linear(512, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        bw, n, c = x.shape
        nh = self.num_heads
        q, k, v = self.qkv(x).reshape(bw, n, 3, nh, c // nh).unbind(2)
        if self.q_bias is not None:
            q, v = q + self.q_bias, v + self.v_bias
        qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)
        kn = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
        attn = torch.einsum("bnhd,bmhd->bhnm", qn, kn)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        attn = attn * scale[None]
        table = array_constant(log_cpb_table, self.window_size,
                               device=x.device)
        bias_table = self.cpb_fc2(F.relu(self.cpb_fc1(table)))
        idx = array_constant(relative_position_index, self.window_size,
                             device=x.device).reshape(-1)
        bias = 16.0 * torch.sigmoid(bias_table[idx].reshape(n, n, nh))
        attn = add_window_mask(attn + bias.permute(2, 0, 1)[None], mask)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.softmax(-1), v)
        return self.proj(out.reshape(bw, n, c))


class SwinBlockV2(nn.Module):
    """V2 block: post-norm residuals, one DropPath called twice."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.attn = WindowAttentionV2(dim, num_heads, window_size)
        self.drop_path = DropPath(drop_path_rate)
        self.norm1 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, shift: int = 0,
                attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        y = cyclic_windows(self.attn, x, self.window_size, shift,
                           attn_mask if shift else None)
        x = x + self.drop_path(self.norm1(y))
        y = self.fc2(_gelu(self.fc1(x)))
        return x + self.drop_path(self.norm2(y))


class SwinTransformerV2(SwinTransformer):
    """V1's stages with V2 blocks; nothing to draw beyond `build_model`'s
    dense and conv layers (the temperatures start at log 10, the q / v
    biases at 0)."""

    BLOCK = SwinBlockV2
