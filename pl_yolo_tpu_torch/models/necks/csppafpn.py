"""CSP-PAFPN neck (YOLOX), port of `pl_yolo_tpu/models/necks/csppafpn.py`.

Top-down path (1x1 shrink -> nearest 2x upsample -> concat -> CSP), then
bottom-up path (stride-2 3x3 conv -> concat -> CSP). 3 inputs, 3 outputs.
NCHW. With `remat` true the four CSP layers run under
`layers.blocks.maybe_checkpoint`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...layers.blocks import (ConvBlock, CSPLayer, DWConvBlock,
                              maybe_checkpoint, upsample_nearest_2x)


class CSPPAFPN(nn.Module):
    """`in_channels` are the output widths (c3, c4, c5), as in the JAX
    package; `feat_channels` are the widths of the three input maps, which
    flax infers and torch needs at build time (default: `in_channels`)."""

    def __init__(self, depths: Sequence[int] = (1, 1, 1, 1),
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False, norm: str = "bn",
                 act: str = "silu",
                 feat_channels: Sequence[int] | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        c3, c4, c5 = in_channels
        a3, a4, a5 = feat_channels or in_channels
        kw = dict(norm=norm, act=act, dtype=dtype)
        csp_kw = dict(num_bottle=depths[0], shortcut=False,
                      depthwise=depthwise, **kw)
        down = DWConvBlock if depthwise else ConvBlock
        self.shrink_conv1 = ConvBlock(a5, c4, 1, **kw)
        self.p5_p4 = CSPLayer(c4 + a4, c4, **csp_kw)
        self.shrink_conv2 = ConvBlock(c4, c3, 1, **kw)
        self.p4_p3 = CSPLayer(c3 + a3, c3, **csp_kw)
        self.downsample_conv1 = down(c3, c3, 3, stride=2, **kw)
        self.n3_n4 = CSPLayer(c3 + c3, c4, **csp_kw)
        self.downsample_conv2 = down(c4, c4, 3, stride=2, **kw)
        self.n4_n5 = CSPLayer(c4 + c4, c5, **csp_kw)
        self.out_channels = [c3, c4, c5]
        self.remat = False   # build_model sets it from the yaml's `remat`

    def _csp(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return maybe_checkpoint(layer, x, self.remat)

    def forward(self, inputs: Sequence[torch.Tensor]):
        c3, c4, c5 = inputs
        # top-down
        p5_expand = self.shrink_conv1(c5)
        p4 = self._csp(self.p5_p4,
                       torch.cat([upsample_nearest_2x(p5_expand), c4], 1))
        p4_expand = self.shrink_conv2(p4)
        p3 = self._csp(self.p4_p3,
                       torch.cat([upsample_nearest_2x(p4_expand), c3], 1))
        # bottom-up
        n3 = p3
        n4 = self._csp(self.n3_n4,
                       torch.cat([self.downsample_conv1(n3), p4_expand], 1))
        n5 = self._csp(self.n4_n5,
                       torch.cat([self.downsample_conv2(n4), p5_expand], 1))
        return (n3, n4, n5)
