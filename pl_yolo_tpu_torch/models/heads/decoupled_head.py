"""Decoupled detection head (YOLOX), port of
`pl_yolo_tpu/models/heads/decoupled_head.py`.

Per-level 1x1 stem to a common width, then a cls branch (2x 3x3 conv ->
1x1 pred) and a reg branch (2x 3x3 conv -> 1x1 box pred + 1x1 obj pred).
The cls/obj prediction biases start at -log((1-p)/p), p=0.01. Each level's
output is the channel concat [reg(4), obj(1), cls(C)], returned NHWC.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...layers.blocks import ConvBlock, DWConvBlock, apply_conv


def _prior_bias(prior_prob: float = 1e-2) -> float:
    return -math.log((1.0 - prior_prob) / prior_prob)


class DecoupledHead(nn.Module):
    """`feat_channels` are the widths of the input maps (default:
    `in_channels`). The 1x1 pred convs run in fp32 whatever the compute
    dtype, as the JAX package's `Conv1x1` promotes to its fp32 kernel.
    Under `parallel: {model}` a pred conv whose cout is sharded adds its
    bias after the channels are gathered (`layers.blocks.apply_conv`)."""

    def __init__(self, num_classes: int = 80, n_anchors: int = 1,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False, norm: str = "bn",
                 act: str = "silu",
                 feat_channels: Sequence[int] | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        width = in_channels[0]
        kw = dict(norm=norm, act=act, dtype=dtype)
        conv = DWConvBlock if depthwise else ConvBlock
        self.num_levels = len(in_channels)
        for k, cin in enumerate(feat_channels or in_channels):
            self.add_module(f"stem{k}", ConvBlock(cin, width, 1, **kw))
            for branch in ("cls", "reg"):
                self.add_module(f"{branch}_conv{k}_0",
                                conv(width, width, 3, **kw))
                self.add_module(f"{branch}_conv{k}_1",
                                conv(width, width, 3, **kw))
            self.add_module(f"cls_pred{k}",
                            nn.Conv2d(width, n_anchors * num_classes, 1))
            self.add_module(f"reg_pred{k}", nn.Conv2d(width, n_anchors * 4, 1))
            self.add_module(f"obj_pred{k}", nn.Conv2d(width, n_anchors, 1))
            nn.init.constant_(getattr(self, f"cls_pred{k}").bias, _prior_bias())
            nn.init.zeros_(getattr(self, f"reg_pred{k}").bias)
            nn.init.constant_(getattr(self, f"obj_pred{k}").bias, _prior_bias())

    def forward(self, inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        outputs = []
        for k, x in enumerate(inputs):
            def m(name):
                return getattr(self, name.format(k=k))
            x = m("stem{k}")(x)
            # the preds in fp32 at least (a float64 model keeps float64)
            cls_feat = m("cls_conv{k}_1")(m("cls_conv{k}_0")(x))
            cls_feat = cls_feat.to(torch.promote_types(cls_feat.dtype,
                                                       torch.float32))
            reg_feat = m("reg_conv{k}_1")(m("reg_conv{k}_0")(x))
            reg_feat = reg_feat.to(torch.promote_types(reg_feat.dtype,
                                                       torch.float32))
            out = torch.cat([apply_conv(m("reg_pred{k}"), reg_feat),
                             apply_conv(m("obj_pred{k}"), reg_feat),
                             apply_conv(m("cls_pred{k}"), cls_feat)], dim=1)
            outputs.append(out.permute(0, 2, 3, 1))
        return outputs
