"""What the attention modules (`layers.attention` and its companions)
share: the NHWC conv call, the bare flax BatchNorms, the head count rule
and multi-head dot-product attention. The JAX package writes these inline
in each module."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm2d

BARE_BN_EPS = 1e-5      # flax nn.BatchNorm's defaults
BARE_BN_MOMENTUM = 0.01  # torch momentum = 1 - flax momentum (0.99)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv applied to an NHWC map."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def bare_batch_norm(num_features: int) -> BatchNorm2d:
    """A bare flax `nn.BatchNorm` that trains (flax's running statistics,
    eps 1e-5, momentum 0.99); NCHW or [B,C,1,1]."""
    return BatchNorm2d(num_features, BARE_BN_EPS, BARE_BN_MOMENTUM)


class FrozenBatchNorm(nn.BatchNorm2d):
    """A flax `nn.BatchNorm(use_running_average=True)`: the running
    statistics normalise in train and eval mode alike, and never move.
    [B,C,...]; `affine=False` for one without scale and bias."""

    def __init__(self, num_features: int, affine: bool = True):
        super().__init__(num_features, eps=BARE_BN_EPS, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def pick_heads(c: int, want: int = 8) -> int:
    """Largest head count <= `want` that divides the channel width."""
    for h in range(min(want, c), 0, -1):
        if c % h == 0:
            return h
    return 1


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dk: int) -> torch.Tensor:
    """softmax(q·kᵀ / sqrt(dk)) · v over [B, N, heads, dk] tokens."""
    att = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(dk)
    return torch.einsum("bhnm,bmhd->bnhd", att.softmax(-1), v)
