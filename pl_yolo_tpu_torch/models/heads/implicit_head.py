"""Implicit head (YOLOv7 / YOLOR), port of
`pl_yolo_tpu/models/heads/implicit_head.py`.

Per level: a learned additive prior `ia{k}` (init N(0, 0.02)) -> a biased
1x1 conv to na*(5+C) -> a learned multiplicative prior `im{k}` (init
1 + N(0, 0.02)). Output per level: NHWC [B, H, W, na*(5+C)], per-anchor
channel blocks [x, y, w, h, obj, cls...].

The head computes in fp32 whatever the model's compute dtype, as the JAX
package's does: there `x + ia` promotes a bf16 map to the fp32 prior, and
its `Conv1x1` promotes to its fp32 kernel. The priors are [1, C, 1, 1] here
and [1, 1, 1, C] in flax (`bridge` maps them).

Under `parallel: {model: M}` each rank may hold a C slice of a prior (the
JAX spec shards it on C where M divides C), which is gathered where it is
used, and a cout slice of a conv, which runs through `apply_conv`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...layers.blocks import apply_conv
from ...parallel.tensor import whole


class ImplicitHead(nn.Module):
    """`in_channels` are the widths of the input maps (flax infers them; the
    config's head `channels` are not read)."""

    # the priors shard on C over the model group (`parallel.tensor`)
    GATHERED_DIM = 1

    def __init__(self, num_classes: int = 80, n_anchors: int = 3,
                 in_channels: Sequence[int] = (256, 512, 1024)):
        super().__init__()
        ch = n_anchors * (5 + num_classes)
        self.num_levels = len(in_channels)
        for k, cin in enumerate(in_channels):
            self.register_parameter(f"ia{k}",
                                    nn.Parameter(torch.zeros(1, cin, 1, 1)))
            self.add_module(f"conv{k}", nn.Conv2d(cin, ch, 1))
            nn.init.zeros_(getattr(self, f"conv{k}").bias)
            self.register_parameter(f"im{k}",
                                    nn.Parameter(torch.ones(1, ch, 1, 1)))

    @torch.no_grad()
    def reset_implicit_(self, generator: torch.Generator) -> None:
        """Draw the priors from `generator`: ia ~ N(0, 0.02), im ~ 1 +
        N(0, 0.02)."""
        for k in range(self.num_levels):
            getattr(self, f"ia{k}").normal_(0.0, 0.02, generator=generator)
            getattr(self, f"im{k}").normal_(1.0, 0.02, generator=generator)

    def forward(self, inputs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        outputs = []
        for k, x in enumerate(inputs):
            x = x.to(torch.promote_types(x.dtype, torch.float32))
            x = x + whole(getattr(self, f"ia{k}"), 1, x.shape[1])
            x = apply_conv(getattr(self, f"conv{k}"), x)
            x = x * whole(getattr(self, f"im{k}"), 1, x.shape[1])
            outputs.append(x.permute(0, 2, 3, 1))
        return outputs
