"""`jax.image.resize(..., "bicubic")`, rebuilt: the ViT and MCTformer
position embeddings (`resize_bicubic`, NHWC, any size) and AL-PAFPN's 2x
upsampling (`upsample_bicubic_2x`, NCHW).

JAX resizes by one einsum of the input with a [in, out] weight matrix per
resized axis, the matrices cast to the input's dtype. Here each
contraction is an einsum of two operands. Under bf16 the weights are
rounded to bf16, and so is the output of each contraction, as JAX's
pairwise contractions round theirs; the axis contracted first is the one
JAX's einsum path picks (the cheaper first step; the rows on a tie), so
that the bf16 result is JAX's.
torch's own bicubic (a = -0.75, no antialias) is another function.
"""

from __future__ import annotations

import numpy as np
import torch

from .constant import array_constant


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel, a = -0.5, on |distance| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] fp32 weights of `jax.image.resize(..., "bicubic")` along one
    axis: half-pixel centres, the kernel widened by in/out when
    downsampling (antialias), each column normalised to sum 1, and columns
    whose sample falls outside the input zeroed (jax/_src/image/scale.py,
    `compute_weight_mat`)."""
    scale = np.float32(out_size) / np.float32(in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale
                - 0.5).astype(np.float32)
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale).astype(np.float32)
    weights = _keys_cubic(x)
    total = np.sum(weights, axis=0, keepdims=True)
    eps = float(np.finfo(np.float32).eps)
    weights = np.where(np.abs(total) > 1000.0 * eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize_bicubic(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C] as `jax.image.resize(x, (B, h, w, C),
    "bicubic")`, in x's dtype (fp32 for the position tables, float64 for
    a float64 module): two small matmuls with the per-axis weights, so the
    result is differentiable in x."""
    wh = array_constant(bicubic_weights, x.shape[1], h, device=x.device)
    ww = array_constant(bicubic_weights, x.shape[2], w, device=x.device)
    wh, ww = wh.to(x.dtype), ww.to(x.dtype)
    x = torch.einsum("hH,bhwc->bHwc", wh, x)
    return torch.einsum("wW,bHwc->bHWc", ww, x)


def upsample_bicubic_2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W] as AL-PAFPN's `jax.image.resize(x,
    (B, 2H, 2W, C), "bicubic")` of the NHWC map, in x's dtype. The rows
    go first unless the map is wider than tall (JAX's einsum path: the
    first step costs 2H²W against 2HW² multiply-adds)."""
    h, w = x.shape[2:]
    wh = array_constant(bicubic_weights, h, 2 * h, device=x.device)
    ww = array_constant(bicubic_weights, w, 2 * w, device=x.device)
    wh, ww = wh.to(x.dtype), ww.to(x.dtype)
    if h >= w:
        x = torch.einsum("bchw,hH->bcHw", x, wh)
        return torch.einsum("bcHw,wW->bcHW", x, ww)
    x = torch.einsum("bchw,wW->bchW", x, ww)
    return torch.einsum("bchW,hH->bcHW", x, wh)
