"""CSPDarkNet backbone (YOLOX family), port of
`pl_yolo_tpu/models/backbones/cspdarknet.py`.

Focus stem + 4 stages of (stride-2 3x3 conv -> CSPLayer); SPP in stage4
before a non-shortcut CSPLayer. Returns the feature maps named in `outputs`
(default stage2/3/4 -> strides 8/16/32). NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...layers.blocks import (ConvBlock, CSPLayer, DWConvBlock, Focus,
                              SPPBottleneck)


class CSPDarkNet(nn.Module):
    def __init__(self, depths: Sequence[int] = (3, 9, 9, 3),
                 channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4"),
                 depthwise: bool = False, norm: str = "bn",
                 act: str = "silu", drop_block_rate: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(norm=norm, act=act, dtype=dtype)
        down = DWConvBlock if depthwise else ConvBlock
        self.outputs = tuple(outputs)
        # DropBlock is a train-mode regularizer (identity in eval); its
        # train form is not ported yet.
        self.drop_block_rate = float(drop_block_rate)
        self.stem = Focus(3, channels[0], ksize=3, **kw)
        widths = {"stem": channels[0]}
        for i in range(4):
            cin, ch = channels[i], channels[i + 1]
            self.add_module(f"stage{i + 1}_down",
                            down(cin, ch, 3, stride=2, **kw))
            if i == 3:
                self.stage4_spp = SPPBottleneck(ch, ch, **kw)
            self.add_module(f"stage{i + 1}_csp", CSPLayer(
                ch, ch, num_bottle=depths[i], shortcut=(i != 3),
                depthwise=depthwise, **kw))
            widths[f"stage{i + 1}"] = ch
        self.out_channels = [widths[k] for k in self.outputs]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        if self.training and self.drop_block_rate > 0.0:
            raise NotImplementedError(
                "CSPDarkNet drop_block in train mode is not ported yet "
                "(ROADMAP queue A, item 10: layers/drops.py)")
        x = self.stem(x)
        feats = {"stem": x}
        for i in range(4):
            x = getattr(self, f"stage{i + 1}_down")(x)
            if i == 3:
                x = self.stage4_spp(x)
            x = getattr(self, f"stage{i + 1}_csp")(x)
            feats[f"stage{i + 1}"] = x
        return [feats[k] for k in self.outputs]
