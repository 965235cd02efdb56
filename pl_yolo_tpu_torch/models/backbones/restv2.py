"""ResTv2 detection backbone, port of `pl_yolo_tpu/models/backbones/restv2.py`.

  * ConvStem: two 3x3 stride-2 conv-BN-ReLU, a 1x1 conv, PA (pixel
    attention), LayerNorm; stride-4 tokens. Its BatchNorms are flax's bare
    `nn.BatchNorm`: eps 1e-5, running-average momentum 0.99 (torch 0.01),
    the biased batch variance kept, in train mode, as `BatchNorm2d` keeps it.
  * PatchEmbed: a (p+1)x(p+1) stride-p conv, PA, LayerNorm between stages.
  * RestBlock: pre-norm EMSAv2 attention + 4x MLP, DropPath on both.
  * EMSAv2: full-resolution queries against keys and values downsampled by
    a depthwise (sr+1)x(sr+1) stride-sr conv, plus an identity branch: v
    through a depthwise 3x3 conv to sr²·C channels, shuffled back to full
    resolution in the JAX package's [C, r, r] grouped channel order (not
    torch's `pixel_shuffle` order), LayerNorm, added before the output
    projection.

NHWC maps inside, the convs on permuted views; NCHW in and out. Every
LayerNorm has eps 1e-6; the attention's logits and softmax run in fp32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...layers.blocks import BatchNorm2d, LayerNorm, SameConv2d
from ...layers.drops import DropPath
from .vit import _gelu, truncated_normal_

FLAX_BN_EPS, FLAX_BN_MOMENTUM = 1e-5, 0.01  # flax nn.BatchNorm's defaults


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv on an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PA(nn.Module):
    """Pixel attention positional encoding: x * sigmoid(dwconv3x3(x))."""

    def __init__(self, channels: int):
        super().__init__()
        self.pa_conv = SameConv2d(channels, channels, 3, groups=channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(conv_nhwc(self.pa_conv, x))


class ConvStem(nn.Module):
    def __init__(self, out_ch: int = 96):
        super().__init__()
        ch, cin = out_ch // 2, 3
        for i in range(2):
            self.add_module(f"conv{i}", SameConv2d(cin, ch, 3, 2, bias=False))
            self.add_module(f"bn{i}", BatchNorm2d(ch, FLAX_BN_EPS,
                                                  FLAX_BN_MOMENTUM))
            cin, ch = ch, ch * 2
        self.proj = nn.Conv2d(cin, out_ch, 1)
        self.pos = PA(out_ch)
        self.norm = LayerNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images -> NHWC tokens at stride 4."""
        for i in range(2):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = self.proj(x).permute(0, 2, 3, 1)
        return self.norm(self.pos(x))


class PatchEmbed(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, patch: int = 2):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, out_ch, patch + 1, patch,
                              padding=patch // 2)
        self.pos = PA(out_ch)
        self.norm = LayerNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.pos(conv_nhwc(self.proj, x)))


class EMSAv2(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        sr = sr_ratio
        self.q = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr + 1, sr, padding=sr // 2,
                                groups=dim)
            self.sr_norm = LayerNorm(dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.up = SameConv2d(dim, sr * sr * dim, 3, groups=dim)
        self.up_norm = LayerNorm(dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh, sr = self.num_heads, self.sr_ratio
        hd = c // nh
        q = self.q(x).reshape(b, h * w, nh, hd)
        kv_in = x
        if sr > 1:
            kv_in = self.sr_norm(conv_nhwc(self.sr, x))
        hk, wk = kv_in.shape[1], kv_in.shape[2]
        k, v = self.kv(kv_in).reshape(b, hk * wk, 2, nh, hd).unbind(2)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
        attn = torch.softmax(attn * hd ** -0.5, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype), v)
        # identity branch: v as a map, depthwise conv to sr²·C channels,
        # shuffled back to full resolution from [C, r, r] groups
        up = conv_nhwc(self.up, v.reshape(b, hk, wk, c))
        up = up.reshape(b, hk, wk, c, sr, sr).permute(0, 1, 4, 2, 5, 3)
        up = self.up_norm(up.reshape(b, hk * sr, wk * sr, c)[:, :h, :w])
        return self.proj(out.reshape(b, h, w, c) + up)


class RestBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EMSAv2(dim, num_heads, sr_ratio)
        self.dp1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.dp2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.dp1(self.attn(self.norm1(x)))
        y = self.fc2(_gelu(self.fc1(self.norm2(x))))
        return x + self.dp2(y)


class ResTV2(nn.Module):
    """Four-stage pyramid (strides 4/8/16/32); returns the `outputs` maps."""

    STEM_S2D = False  # a conv stem on the raw images: NHWC batches

    def __init__(self, depths: Sequence[int] = (1, 2, 6, 2),
                 embed_dims: Sequence[int] = (96, 192, 384, 768),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 drop_path_rate: float = 0.0,
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4")):
        super().__init__()
        self.depths, self.outputs = tuple(depths), tuple(outputs)
        dpr = [float(r) for r in
               np.linspace(0.0, drop_path_rate, sum(depths))]
        cur = 0
        for s in range(4):
            if s == 0:
                self.stem = ConvStem(embed_dims[0])
            else:
                self.add_module(f"patch_{s + 1}", PatchEmbed(
                    embed_dims[s - 1], embed_dims[s], 2))
            for i in range(depths[s]):
                self.add_module(f"stage{s + 1}_block{i}", RestBlock(
                    embed_dims[s], num_heads[s], sr_ratios[s], dpr[cur + i]))
            cur += depths[s]
        self.norm = LayerNorm(embed_dims[3])
        self.out_channels = [embed_dims[int(k[len("stage"):]) - 1]
                             for k in self.outputs]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = {}
        for s in range(4):
            x = (self.stem(x) if s == 0
                 else getattr(self, f"patch_{s + 1}")(x))
            for i in range(self.depths[s]):
                x = getattr(self, f"stage{s + 1}_block{i}")(x)
            if s == 3:
                x = self.norm(x)
            feats[f"stage{s + 1}"] = x
        return [feats[k].permute(0, 3, 1, 2) for k in self.outputs]

    def init_weights_(self, generator: torch.Generator) -> None:
        """The MLPs' dense kernels: truncated normal (sd 0.02), as flax
        initialises them; the other layers are `build_model`'s."""
        for m in self.modules():
            if isinstance(m, RestBlock):
                truncated_normal_(m.fc1.weight, generator)
                truncated_normal_(m.fc2.weight, generator)
