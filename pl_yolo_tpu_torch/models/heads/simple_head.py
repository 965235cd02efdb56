"""Plain per-level 1x1 conv head of the YOLOv5-style anchor pipeline, port
of `pl_yolo_tpu/models/heads/simple_head.py`. Output per level: NHWC
[B, H, W, na*(5+C)].

The convs run in fp32 whatever the model's compute dtype, as the JAX
package's `Conv1x1` promotes to its fp32 kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class SimpleHead(nn.Module):
    """`in_channels` are the widths of the input maps (flax infers them; the
    config's head `channels` are not read)."""

    def __init__(self, num_classes: int = 80, n_anchors: int = 3,
                 in_channels: Sequence[int] = (256, 512, 1024)):
        super().__init__()
        ch = n_anchors * (5 + num_classes)
        for k, cin in enumerate(in_channels):
            self.add_module(f"conv{k}", nn.Conv2d(cin, ch, 1))
            nn.init.zeros_(getattr(self, f"conv{k}").bias)

    def forward(self, inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [getattr(self, f"conv{k}")(x.float()).permute(0, 2, 3, 1)
                for k, x in enumerate(inputs)]
