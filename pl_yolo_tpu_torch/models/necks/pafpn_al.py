"""AL-PAFPN neck (e-YOLOX), port of `pl_yolo_tpu/models/necks/pafpn_al.py`.

Top-down path (1x1 shrink -> bicubic 2x upsample -> concat -> 1x1 shrink
-> mobile CSP), then bottom-up path (stride-2 3x3 conv -> concat with the
top-down path's shrunk map -> mobile CSP). Every CSP is a
`MobileCSPLayer(num_bottle=depths[0], shortcut=False)`, which keeps its
width. 3 inputs, 3 outputs. NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...layers.blocks import ConvBlock
from ...ops.resize import upsample_bicubic_2x
from ..backbones.mobile import MobileCSPLayer


class AL_PAFPN(nn.Module):
    """`in_channels` are the config's widths (c3, c4, c5), as in the JAX
    package; `feat_channels` are the widths of the three input maps, which
    flax infers and torch needs at build time (default: `in_channels`).
    The outputs are as wide as p3, then twice c3 and twice c4."""

    def __init__(self, depths: Sequence[int] = (1, 1, 1, 1),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 norm: str = "bn", act: str = "silu",
                 feat_channels: Sequence[int] | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        c3, c4, _ = in_channels
        a3, a4, a5 = feat_channels or in_channels
        kw = dict(norm=norm, act=act, dtype=dtype)

        def csp(width):
            return MobileCSPLayer(width, num_bottle=depths[0],
                                  shortcut=False, **kw)
        self.shrink_conv1 = ConvBlock(a5, c4, 1, **kw)
        self.shrink_conv2 = ConvBlock(c4 + a4, c4, 1, **kw)
        self.p5_p4 = csp(c4)
        self.shrink_conv3 = ConvBlock(self.p5_p4.out_channels, c3, 1, **kw)
        self.shrink_conv4 = ConvBlock(c3 + a3, c3, 1, **kw)
        self.p4_p3 = csp(c3)
        n3 = self.p4_p3.out_channels
        self.downsample_conv1 = ConvBlock(n3, c3, 3, stride=2, **kw)
        self.n3_n4 = csp(c3 + c3)
        self.downsample_conv2 = ConvBlock(self.n3_n4.out_channels, c4, 3,
                                          stride=2, **kw)
        self.n4_n5 = csp(c4 + c4)
        self.out_channels = [n3, self.n3_n4.out_channels,
                             self.n4_n5.out_channels]

    def forward(self, inputs: Sequence[torch.Tensor]):
        c3, c4, c5 = inputs
        # top-down
        p5_expand = self.shrink_conv1(c5)
        p4 = torch.cat([upsample_bicubic_2x(p5_expand), c4], 1)
        p4 = self.p5_p4(self.shrink_conv2(p4))
        p4_expand = self.shrink_conv3(p4)
        p3 = torch.cat([upsample_bicubic_2x(p4_expand), c3], 1)
        p3 = self.p4_p3(self.shrink_conv4(p3))
        # bottom-up, against the top-down path's shrunk maps
        n3 = p3
        n4 = self.n3_n4(torch.cat([self.downsample_conv1(n3), p4_expand], 1))
        n5 = self.n4_n5(torch.cat([self.downsample_conv2(n4), p5_expand], 1))
        return (n3, n4, n5)
