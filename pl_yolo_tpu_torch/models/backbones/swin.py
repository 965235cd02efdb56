"""Swin Transformer multi-scale detection backbone, port of
`pl_yolo_tpu/models/backbones/swin.py`.

A 4x4 patch embed, 4 stages of shifted-window attention blocks with
PatchMerging between them, relative-position-biased window attention, a
LayerNorm on each output stage, and outputs at strides (4, 8, 16, 32) for
`neck: none`. The blocks run on NHWC maps and [windows, tokens, C] windows;
the backbone takes NCHW images and returns NCHW maps.

As in the JAX package, a stage's map is padded with zeros up to a multiple
of its window before its blocks, and the padded tokens are not masked (the
reference masks them); the window of a stage is min(window_size, h, w), so
a stage whose map is smaller than the window has a smaller relative
position table. The tables' shapes therefore depend on the input size, as
they depend on the size a flax init sees: the module is built for
`input_size` and refuses a map that would need another window.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...layers.blocks import LayerNorm, SameConv2d, get_activation
from ...layers.drops import DropPath
from ...ops.constant import array_constant

_gelu = get_activation("gelu")  # flax nn.gelu: the tanh approximation


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ws*ws, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, ws*ws, C] -> [B, H, W, C]."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """[ws², ws²] int64 rows of the relative position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """[nW, ws², ws²] fp32 attention mask of the shifted windows: -100.0
    between tokens of different regions, 0.0 within one."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for ws_ in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, ws_, :] = cnt
            cnt += 1
    windows = np.reshape(img, (1, h // ws, ws, w // ws, ws, 1))
    windows = windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def add_window_mask(attn: torch.Tensor, mask: torch.Tensor | None
                    ) -> torch.Tensor:
    """attn [B*nW, heads, n, n] plus the [nW, n, n] mask of each window."""
    if mask is None:
        return attn
    bnw, heads, n, _ = attn.shape
    nw = mask.shape[0]
    attn = attn.reshape(bnw // nw, nw, heads, n, n) + mask[None, :, None]
    return attn.reshape(bnw, heads, n, n)


class WindowAttention(nn.Module):
    """Relative-position-biased MSA within windows: q·scale, q kᵀ, + bias,
    + mask, softmax, · v, as the JAX package orders them."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        bnw, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(bnw, n, 3, nh, hd)
        q, k, v = qkv.unbind(2)                               # [bnw, n, h, d]
        attn = torch.einsum("bnhd,bmhd->bhnm", q * hd ** -0.5, k)
        idx = array_constant(relative_position_index, self.window_size,
                             device=x.device).reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, nh)
        attn = add_window_mask(attn + bias.permute(2, 0, 1)[None], mask)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.softmax(-1), v)
        return self.proj(out.reshape(bnw, n, c))


def cyclic_windows(attn: nn.Module, x: torch.Tensor, ws: int, shift: int,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """`attn` over the (shifted) windows of x [B, H, W, C], back in place."""
    b, h, w, c = x.shape
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    x = window_reverse(attn(window_partition(x, ws), mask), ws, h, w)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x


class SwinBlock(nn.Module):
    """W-MSA / SW-MSA block with stochastic depth on both residual branches
    (one DropPath, called twice: two draws). The window shift is an
    argument of the call: it follows the stage's map size."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, shift: int = 0,
                attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        y = cyclic_windows(self.attn, self.norm1(x), self.window_size, shift,
                           attn_mask if shift else None)
        x = x + self.drop_path(y)
        y = self.fc2(_gelu(self.fc1(self.norm2(x))))
        return x + self.drop_path(y)


class PatchMerging(nn.Module):
    """2x2 patch merge + linear reduce, the reference's concat order:
    (0::2,0::2), (1::2,0::2), (0::2,1::2), (1::2,1::2)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                       x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x))


def stage_windows(input_size: Sequence[int], patch_size: int, stages: int,
                  window_size: int) -> list[int]:
    """Each stage's window, min(window_size, h, w), for `input_size`."""
    h, w = (-(-s // patch_size) for s in input_size)
    out = []
    for _ in range(stages):
        out.append(min(window_size, h, w))
        h, w = h // 2, w // 2
    return out


class SwinTransformer(nn.Module):
    STEM_S2D = False  # a patch-embed stem: the trainer feeds NHWC images
    BLOCK = SwinBlock

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 patch_size: int = 4, out_indices: Sequence[int] = (1, 2, 3),
                 drop_path_rate: float = 0.0,
                 input_size: Sequence[int] = (640, 640)):
        super().__init__()
        self.depths, self.out_indices = tuple(depths), tuple(out_indices)
        self.window_size = window_size
        self.input_size = tuple(input_size)
        self.windows = stage_windows(input_size, patch_size, len(depths),
                                     window_size)
        self.patch_embed = SameConv2d(3, embed_dim, patch_size, patch_size)
        self.patch_norm = LayerNorm(embed_dim)
        total = sum(depths)
        # the stochastic-depth ramp rate·i/(total-1) over all blocks
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        dim, done, self.out_channels = embed_dim, 0, []
        for si, depth in enumerate(depths):
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", self.BLOCK(
                    dim, num_heads[si], window_size=self.windows[si],
                    mlp_ratio=mlp_ratio, drop_path_rate=dpr[done + bi]))
            done += depth
            if si in self.out_indices:
                self.add_module(f"out_norm{si}", LayerNorm(dim))
                self.out_channels.append(dim)
            if si < len(depths) - 1:
                self.add_module(f"merge{si}", PatchMerging(dim))
                dim *= 2

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.patch_norm(self.patch_embed(x).permute(0, 2, 3, 1))
        outs = []
        for si, depth in enumerate(self.depths):
            h, w = x.shape[1], x.shape[2]
            ws = min(self.window_size, h, w)
            if ws != self.windows[si]:
                raise ValueError(
                    f"stage {si}'s {h}x{w} map needs a window of {ws}; this "
                    f"backbone was built for input {self.input_size}, "
                    f"window {self.windows[si]} (build_model's input_size)")
            shift = ws // 2
            ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
            if ph or pw:  # zeros, unmasked, as the JAX package pads
                x = F.pad(x, (0, 0, 0, pw, 0, ph))
            hh, ww = x.shape[1], x.shape[2]
            mask = (array_constant(shift_attn_mask, hh, ww, ws, shift,
                                   device=x.device)
                    if shift > 0 and (hh > ws or ww > ws) else None)
            for bi in range(depth):
                blk_shift = shift if bi % 2 and mask is not None else 0
                x = getattr(self, f"stage{si}_block{bi}")(x, blk_shift, mask)
            x = x[:, :h, :w]
            if si in self.out_indices:
                out = getattr(self, f"out_norm{si}")(x)
                outs.append(out.permute(0, 3, 1, 2))
            if si < len(self.depths) - 1:
                x = getattr(self, f"merge{si}")(x)
        return outs

    def init_weights_(self, generator: torch.Generator) -> None:
        """The relative position tables, truncated normal (sd 0.02), as
        flax initialises them; the dense and conv layers are
        `build_model`'s."""
        for m in self.modules():
            if isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, 0.0,
                                      0.02, -0.04, 0.04, generator=generator)
