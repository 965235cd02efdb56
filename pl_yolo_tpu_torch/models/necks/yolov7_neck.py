"""YOLOv7 neck, port of `pl_yolo_tpu/models/necks/yolov7_neck.py`: an
SPPCSPC entry, ELAN-style CSP blocks, Transition downsamples and 3x3 output
convs (optionally RepConv). 3 inputs, 3 outputs. NCHW.

RepConv's three training branches (3x3 + BN, 1x1 + BN, identity BN) collapse
into one biased 3x3 conv for deployment (`utils.fuse.fuse_repconv`).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...layers.blocks import (BN_EPS, BN_MOMENTUM, SPPCSPC, BatchNorm2d,
                              ConvBlock, apply_conv, get_activation,
                              upsample_nearest_2x)
from ..backbones.eelan import max_pool_stride2


class V7CSPLayer(nn.Module):
    """ELAN-style aggregation: [1x1(x), 1x1(x), a 1x1 of that, then
    `num_bottle` chained 3x3s, all concatenated] -> 1x1 fuse."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_bottle: int = 1, expansion: float = 0.5,
                 norm: str = "bn", act: str = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        hidden = int(in_channels * expansion)
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.num_bottle = num_bottle
        self.conv1 = ConvBlock(in_channels, hidden, 1, **kw)
        self.conv2 = ConvBlock(in_channels, hidden, 1, **kw)
        self.conv3 = ConvBlock(hidden, hidden // 2, 1, **kw)
        for i in range(num_bottle):
            self.add_module(f"conv4_{i}",
                            ConvBlock(hidden // 2, hidden // 2, 3, **kw))
        self.conv5 = ConvBlock(2 * hidden + (num_bottle + 1) * (hidden // 2),
                               out_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        x2 = self.conv2(x)
        x3 = self.conv3(x2)
        parts = [x1, x2, x3]
        for i in range(self.num_bottle):
            x3 = getattr(self, f"conv4_{i}")(x3)
            parts.append(x3)
        return self.conv5(torch.cat(parts, dim=1))


class V7Transition(nn.Module):
    """MaxPool + 1x1 || 1x1 + 3x3 stride 2, with explicit out channels."""

    def __init__(self, in_channels: int, out_channels: int, norm: str = "bn",
                 act: str = "silu", dtype: torch.dtype | None = None):
        super().__init__()
        half = out_channels // 2
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.conv1 = ConvBlock(in_channels, half, 1, **kw)
        self.conv2 = ConvBlock(in_channels, half, 1, **kw)
        self.conv3 = ConvBlock(half, half, 3, stride=2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(max_pool_stride2(x))
        x2 = self.conv3(self.conv2(x))
        return torch.cat([x2, x1], dim=1)


class RepConv(nn.Module):
    """RepVGG-style re-parameterizable 3x3 conv: 3x3 + BN, 1x1 + BN and,
    when the shapes allow, an identity BN, summed before the activation.

    It computes in fp32 whatever the model's compute dtype: the JAX
    package's RepConv uses bare `nn.Conv` / `nn.BatchNorm` without a dtype,
    which promote a bf16 input to their fp32 params. Both convs run
    through `apply_conv`: on a band of rows (`parallel: {spatial}`) the
    3x3 takes its halo rows, and a cout slice (`{model}`) gathers its
    channels; the identity BN is local."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 act: str = "silu"):
        super().__init__()
        self.rbr_dense_conv = nn.Conv2d(in_channels, out_channels, 3, stride,
                                        1, bias=False)
        self.rbr_dense_bn = BatchNorm2d(out_channels, BN_EPS, BN_MOMENTUM)
        self.rbr_1x1_conv = nn.Conv2d(in_channels, out_channels, 1, stride,
                                      bias=False)
        self.rbr_1x1_bn = BatchNorm2d(out_channels, BN_EPS, BN_MOMENTUM)
        self.rbr_identity = (BatchNorm2d(in_channels, BN_EPS, BN_MOMENTUM)
                             if in_channels == out_channels and stride == 1
                             else None)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        out = (self.rbr_dense_bn(apply_conv(self.rbr_dense_conv, x))
               + self.rbr_1x1_bn(apply_conv(self.rbr_1x1_conv, x)))
        if self.rbr_identity is not None:
            out = out + self.rbr_identity(x)
        return self.act(out)


class YOLOv7NECK(nn.Module):
    """3-in / 3-out PAFPN with an SPPCSPC entry. `in_channels` are the
    JAX package's (only the last, the base width, sets the layer widths);
    `feat_channels` are the widths of the three input maps, which flax
    infers and torch needs at build time (default: `in_channels`)."""

    def __init__(self, depths: Sequence[int] = (1, 1, 1, 1),
                 in_channels: Sequence[int] = (512, 1024, 1024),
                 use_repconv: bool = False, norm: str = "bn",
                 act: str = "silu",
                 feat_channels: Sequence[int] | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        a3, a4, a5 = feat_channels or in_channels
        base = in_channels[2]
        d = depths[0]
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.spp = SPPCSPC(a5, base // 2, **kw)
        self.conv_for_P5 = ConvBlock(base // 2, base // 4, 1, **kw)
        self.conv_for_C4 = ConvBlock(a4, base // 4, 1, **kw)
        self.p5_p4 = V7CSPLayer(base // 2, base // 4, num_bottle=d, **kw)
        self.conv_for_P4 = ConvBlock(base // 4, base // 8, 1, **kw)
        self.conv_for_C3 = ConvBlock(a3, base // 8, 1, **kw)
        self.p4_p3 = V7CSPLayer(base // 4, base // 8, num_bottle=d, **kw)
        self.downsample_conv1 = V7Transition(base // 8, base // 4, **kw)
        self.n3_n4 = V7CSPLayer(base // 2, base // 4, num_bottle=d, **kw)
        self.downsample_conv2 = V7Transition(base // 4, base // 2, **kw)
        self.n4_n5 = V7CSPLayer(base, base // 2, num_bottle=d, **kw)
        outs = ((base // 8, base // 4), (base // 4, base // 2),
                (base // 2, base))
        for name, (cin, cout) in zip(("n3_out", "n4_out", "n5_out"), outs):
            self.add_module(name, RepConv(cin, cout, act=act) if use_repconv
                            else ConvBlock(cin, cout, 3, **kw))
        self.out_channels = [cout for _, cout in outs]

    def forward(self, inputs: Sequence[torch.Tensor]):
        c3, c4, c5 = inputs
        p5 = self.spp(c5)
        p4 = torch.cat([upsample_nearest_2x(self.conv_for_P5(p5)),
                        self.conv_for_C4(c4)], 1)
        p4 = self.p5_p4(p4)
        p3 = torch.cat([upsample_nearest_2x(self.conv_for_P4(p4)),
                        self.conv_for_C3(c3)], 1)
        n3 = self.p4_p3(p3)
        n4 = self.n3_n4(torch.cat([self.downsample_conv1(n3), p4], 1))
        n5 = self.n4_n5(torch.cat([self.downsample_conv2(n4), p5], 1))
        return (self.n3_out(n3), self.n4_out(n4), self.n5_out(n5))
