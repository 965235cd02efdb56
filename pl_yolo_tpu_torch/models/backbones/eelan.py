"""E-ELAN backbone (YOLOv7), port of `pl_yolo_tpu/models/backbones/eelan.py`.

A 3-conv stem (3 -> 32 -> c0 stride 2 -> c0), then 4 stages: stage 1 is a
stride-2 conv and an ELAN block, stages 2-4 a max-pool + conv Transition
and an ELAN block, with an SPP before the ELAN in stage 4. NCHW. There is
no Focus stem, so the backbone takes the NHWC images as they come
(`STEM_S2D` is false: the trainer feeds it the augmentation's NHWC output).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers.blocks import ConvBlock, SPPBottleneck
from ...parallel.mesh import spatial_layout


class ELANBlock(nn.Module):
    """4-branch ELAN aggregation: two 1x1 projections, two stacks of
    `num_conv` 3x3 convs chained off the second, concat all four -> 1x1
    fuse. num_conv = num_bottle // 2 (at least 1)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_bottle: int = 1, expansion: float = 0.5,
                 norm: str = "bn", act: str = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        hidden = int(in_channels * expansion)
        self.num_conv = num_bottle // 2 if num_bottle > 2 else 1
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.conv1 = ConvBlock(in_channels, hidden, 1, **kw)
        self.conv2 = ConvBlock(in_channels, hidden, 1, **kw)
        for branch in (3, 4):
            for i in range(self.num_conv):
                self.add_module(f"conv{branch}_{i}",
                                ConvBlock(hidden, hidden, 3, **kw))
        self.conv5 = ConvBlock(4 * hidden, out_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        x2 = self.conv2(x)
        x3 = x2
        for i in range(self.num_conv):
            x3 = getattr(self, f"conv3_{i}")(x3)
        x4 = x3
        for i in range(self.num_conv):
            x4 = getattr(self, f"conv4_{i}")(x4)
        return self.conv5(torch.cat([x1, x2, x3, x4], dim=1))


def max_pool_stride2(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k max pool at stride k, VALID (no padding), NCHW.

    Local on a band of rows (`parallel: {spatial: S}`) as long as each
    band holds a multiple of k rows: the windows then never cross a
    band's edge. The pools (E-ELAN's `Transition`s of stages 2-4 and the
    YOLOv7 neck's `V7Transition`s) take maps at strides 4, 8 and 16, whose
    bands hold H / (4·S), H / (8·S) and H / (16·S) rows; the trainer's
    check H % (32·S) == 0 makes the coarsest 2·H / (32·S), even, and the
    finer ones multiples of it."""
    if x.shape[2] % k and spatial_layout() is not None:
        raise ValueError(f"a VALID {k}x{k} stride-{k} pool of {x.shape[2]} "
                         f"rows: a band must hold a multiple of {k} rows")
    return F.max_pool2d(x, k, stride=k)


class Transition(nn.Module):
    """MaxPool + 1x1 || 1x1 + 3x3 stride 2 downsample; the output has the
    input's width (two half-width branches, concatenated)."""

    def __init__(self, in_channels: int, norm: str = "bn", act: str = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        half = in_channels // 2
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.conv1 = ConvBlock(in_channels, half, 1, **kw)
        self.conv2 = ConvBlock(in_channels, half, 1, **kw)
        self.conv3 = ConvBlock(half, half, 3, stride=2, **kw)
        self.out_channels = 2 * half

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(max_pool_stride2(x))
        x2 = self.conv3(self.conv2(x))
        return torch.cat([x2, x1], dim=1)


class EELAN(nn.Module):
    STEM_S2D = False  # a 3x3 conv stem: no space-to-depth input

    def __init__(self, depths: Sequence[int] = (4, 4, 4, 4),
                 channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4"),
                 norm: str = "bn", act: str = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(norm=norm, act=act, dtype=dtype)
        ch = channels
        self.outputs = tuple(outputs)
        self.stem0 = ConvBlock(3, 32, 3, 1, **kw)
        self.stem1 = ConvBlock(32, ch[0], 3, 2, **kw)
        self.stem2 = ConvBlock(ch[0], ch[0], 3, 1, **kw)
        self.stage1_down = ConvBlock(ch[0], ch[1], 3, 2, **kw)
        self.stage1_elan = ELANBlock(ch[1], ch[2], num_bottle=depths[0], **kw)
        widths = {"stem": ch[0], "stage1": ch[2]}
        width = ch[2]
        for i, out in ((2, ch[3]), (3, ch[4]), (4, ch[4])):
            trans = Transition(width, **kw)
            self.add_module(f"stage{i}_trans", trans)
            width = trans.out_channels
            if i == 4:
                self.stage4_spp = SPPBottleneck(width, ch[4], **kw)
                width = ch[4]
            self.add_module(f"stage{i}_elan", ELANBlock(
                width, out, num_bottle=depths[i - 1], **kw))
            widths[f"stage{i}"] = width = out
        self.out_channels = [widths[k] for k in self.outputs]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem2(self.stem1(self.stem0(x)))
        feats = {"stem": x}
        x = self.stage1_elan(self.stage1_down(x))
        feats["stage1"] = x
        for i in (2, 3, 4):
            x = getattr(self, f"stage{i}_trans")(x)
            if i == 4:
                x = self.stage4_spp(x)
            x = getattr(self, f"stage{i}_elan")(x)
            feats[f"stage{i}"] = x
        return [feats[k] for k in self.outputs]
