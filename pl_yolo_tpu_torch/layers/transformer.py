"""Standalone transformer primitives, port of
`pl_yolo_tpu/layers/transformer.py`: `MultiHeadAttention` and the pre-norm
`TransformerLayer` over [B, N, C] tokens, the plug-in forms for custom
architectures (the Swin and ViT backbones embed their own variants), and
`SwinTransformerLayer`, the Swin block under its plug-in name."""

from __future__ import annotations

import torch
from torch import nn

from ..models.backbones.swin import (SwinBlock, window_partition,  # noqa: F401
                                     window_reverse)
from .blocks import LayerNorm, get_activation

_gelu = get_activation("gelu")


class MultiHeadAttention(nn.Module):
    """Standard MHA over [B, N, C] tokens: q·hd^-0.5, q kᵀ, softmax, ·v."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        hd = self.dim // self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, hd).unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q * hd ** -0.5, k)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.softmax(-1), v)
        return self.proj(out.reshape(b, n, self.dim))


class TransformerLayer(nn.Module):
    """Pre-norm encoder block: MHA + MLP with residuals."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


SwinTransformerLayer = SwinBlock  # the plug-in name of the Swin block
