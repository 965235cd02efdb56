"""ShuffleNetV2+ backbone, port of
`pl_yolo_tpu/models/backbones/shufflenetv2.py`.

A 3x3 stride-2 hswish stem, then 4 stages of Shufflenet / Shuffle-Xception
units in the reference's per-stage (block type, kernel) layouts; a
stride-1 unit splits its input into even and odd channels, a stride-2 unit
adds a dw + pw projection branch. NCHW.

The optional squeeze-excite (`use_se`) is two bare 1x1 convs with a bias,
as flax `nn.Conv`s without a dtype: they compute in fp32 whatever the
model's compute dtype, and so does the gate's product, so that under
`dtype: bfloat16` a unit with the SE, and so every stage map, is fp32, as
in the JAX package (its next convs take bf16 again).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers.blocks import ConvBlock


def channel_shuffle_split(x: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved channel split of an NCHW map: (even channels, odd
    channels)."""
    return x[:, 0::2], x[:, 1::2]


class SELayer(nn.Module):
    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def init_weights_(self, gen: torch.Generator) -> None:
        # flax's zero biases (build_model draws the kernels)
        nn.init.zeros_(self.fc1.bias)
        nn.init.zeros_(self.fc2.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax promotes a bf16 input and fp32 params to fp32
        dtype = torch.promote_types(x.dtype, self.fc1.weight.dtype)
        s = x.mean((2, 3), keepdim=True).to(dtype)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * F.hardsigmoid(s)


class _Unit(nn.Module):
    """What both unit types share: the input split, the optional SE on the
    main branch, the stride-2 projection and the concat."""

    def _init_tail(self, in_ch: int, outputs: int, ksize: int, stride: int,
                   use_se: bool, kw: dict) -> None:
        self.stride = stride
        self.se = SELayer(outputs) if use_se else None
        if stride == 2:
            self.proj_dw = ConvBlock(in_ch, in_ch, ksize, 2, groups=in_ch,
                                     norm="bn", act=None, dtype=kw["dtype"])
            self.proj_pw = ConvBlock(in_ch, in_ch, 1, **kw)

    def main(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (the projection branch's input, the main branch's input)
        x_proj, xm = channel_shuffle_split(x) if self.stride == 1 else (x, x)
        y = self.main(xm)
        if self.se is not None:
            y = self.se(y)
        if self.stride == 2:
            x_proj = self.proj_pw(self.proj_dw(x_proj))
        return torch.cat([x_proj, y], 1)


class ShuffleUnit(_Unit):
    """pw -> dw kxk -> pw-linear main branch."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 stride: int = 1, act: str = "hswish", use_se: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        in_ch = in_channels // 2 if stride == 1 else in_channels
        mid, outputs = out_channels // 2, out_channels - in_ch
        kw = dict(norm="bn", act=act, dtype=dtype)
        self.pw1 = ConvBlock(in_ch, mid, 1, **kw)
        self.dw = ConvBlock(mid, mid, ksize, stride, groups=mid, norm="bn",
                            act=None, dtype=dtype)
        self.pw2 = ConvBlock(mid, outputs, 1, **kw)
        self._init_tail(in_ch, outputs, ksize, stride, use_se, kw)

    def main(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw2(self.dw(self.pw1(x)))


class ShuffleXception(_Unit):
    """(dw3 -> pw) x3 main branch; every dw conv has the unit's stride."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 act: str = "hswish", use_se: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        in_ch = in_channels // 2 if stride == 1 else in_channels
        mid, outputs = out_channels // 2, out_channels - in_ch
        kw = dict(norm="bn", act=act, dtype=dtype)
        dw = dict(norm="bn", act=None, dtype=dtype)
        self.dw1 = ConvBlock(in_ch, in_ch, 3, stride, groups=in_ch, **dw)
        self.pw1 = ConvBlock(in_ch, mid, 1, **kw)
        self.dw2 = ConvBlock(mid, mid, 3, stride, groups=mid, **dw)
        self.pw2 = ConvBlock(mid, mid, 1, **kw)
        self.dw3 = ConvBlock(mid, mid, 3, stride, groups=mid, **dw)
        self.pw3 = ConvBlock(mid, outputs, 1, **kw)
        self._init_tail(in_ch, outputs, 3, stride, use_se, kw)

    def main(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw1(self.dw1(x))
        y = self.pw2(self.dw2(y))
        return self.pw3(self.dw3(y))


# per-stage unit layouts (the reference's shufflenetv2.py:34-69):
# (type, ksize), "s" a Shufflenet unit, "x" a Shuffle-Xception one
_STAGES = (
    (("s", 3), ("s", 3), ("x", 3), ("s", 5)),
    (("s", 3), ("s", 3), ("x", 3), ("x", 3)),
    (("s", 7), ("s", 3), ("s", 7), ("s", 5), ("s", 5), ("s", 3), ("s", 7), ("s", 3)),
    (("s", 7), ("s", 5), ("x", 3), ("s", 7)),
)


class ShuffleNetV2(nn.Module):
    def __init__(self, channels: Sequence[int] = (36, 104, 208, 416),
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4"),
                 act: str = "hswish", use_se: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.outputs = tuple(outputs)
        self.stem = ConvBlock(3, 16, 3, stride=2, norm="bn", act="hswish",
                              dtype=dtype)
        widths = {"stem": 16}
        width = 16
        self.stages = []
        for si, stage in enumerate(_STAGES):
            ch, names = channels[si], []
            for bi, (typ, k) in enumerate(stage):
                stride = 2 if bi == 0 else 1
                name = f"stage{si + 1}_b{bi}"
                if typ == "s":
                    unit = ShuffleUnit(width, ch, ksize=k, stride=stride,
                                       act=act, use_se=use_se, dtype=dtype)
                else:
                    unit = ShuffleXception(width, ch, stride=stride, act=act,
                                           use_se=use_se, dtype=dtype)
                self.add_module(name, unit)
                names.append(name)
                width = ch
            self.stages.append(names)
            widths[f"stage{si + 1}"] = width
        self.out_channels = [widths[k] for k in self.outputs]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem(x)
        feats = {"stem": x}
        for si, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            feats[f"stage{si + 1}"] = x
        return [feats[k] for k in self.outputs]
