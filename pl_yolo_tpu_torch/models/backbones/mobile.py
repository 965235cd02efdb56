"""Mobile backbone family: CSPMobileNext, ECMNet, MobileNetV3 S/L, port of
`pl_yolo_tpu/models/backbones/mobile.py`.

The shared building block is the MobileNeXt 'sandglass' bottleneck (dw3x3
-> pw-expand -> pw-reduce -> dw3x3, the activation only on the pw-expand
and after the residual add). CSPMobileNext and ECMNet share one skeleton: a
Focus stem, then four (stride-2 3x3 conv -> block) stages, SPP before
stage 4's block. MobileNetV3 is the inverted-residual table network with
hard-swish and squeeze-excite. NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...layers.blocks import (ConvBlock, Focus, SPPBottleneck, get_activation,
                              spatial_mean)


class SandglassBlock(nn.Module):
    """dw3x3(bn) -> 1x1 expand(act, no norm) -> 1x1 reduce(bn) ->
    dw3x3(bn), the residual when the widths match, then the activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 expansion: float = 2.0, shortcut: bool = True,
                 norm: str = "bn", act: str = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv0 = ConvBlock(in_channels, in_channels, 3,
                               groups=in_channels, norm=norm, act=None,
                               dtype=dtype)
        self.conv1 = ConvBlock(in_channels, hidden, 1, norm=None, act=act,
                               dtype=dtype)
        self.conv2 = ConvBlock(hidden, out_channels, 1, norm=norm, act=None,
                               dtype=dtype)
        self.conv3 = ConvBlock(out_channels, out_channels, 3,
                               groups=out_channels, norm=norm, act=None,
                               dtype=dtype)
        self.use_add = shortcut and in_channels == out_channels
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(self.conv0(x))))
        return self.act(y + x if self.use_add else y)


class MobileCSPLayer(nn.Module):
    """Two half-width 1x1 branches, `num_bottle - 1` sandglass blocks on the
    first, concat [second, first] and the activation; no fuse conv."""

    def __init__(self, in_channels: int, num_bottle: int = 1,
                 shortcut: bool = True, norm: str = "bn", act: str = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        half = in_channels // 2
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.conv1 = ConvBlock(in_channels, half, 1, **kw)
        self.conv2 = ConvBlock(in_channels, half, 1, **kw)
        self.num_sandglass = max(num_bottle - 1, 0)
        for i in range(self.num_sandglass):
            self.add_module(f"m{i}", SandglassBlock(
                half, half, expansion=2.0, shortcut=shortcut, **kw))
        self.act = get_activation(act)
        self.out_channels = 2 * half

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        x2 = self.conv2(x)
        for i in range(self.num_sandglass):
            x1 = getattr(self, f"m{i}")(x1)
        return self.act(torch.cat([x2, x1], 1))


class ELANSandglassLayer(nn.Module):
    """Four quarter-width branches, ELAN-style: x1, x2, x3 = sandglass
    stack on x2, x4 = another on x3, each stack `num_bottle // 2` deep (1
    for `num_bottle` <= 2); concat [x1, x2, x3, x4], no activation after."""

    def __init__(self, in_channels: int, num_bottle: int = 1,
                 norm: str = "bn", act: str = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        quarter = in_channels // 4
        self.num_conv = num_bottle // 2 if num_bottle > 2 else 1
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.conv1 = ConvBlock(in_channels, quarter, 1, **kw)
        self.conv2 = ConvBlock(in_channels, quarter, 1, **kw)
        for branch in (3, 4):
            for i in range(self.num_conv):
                self.add_module(f"conv{branch}_{i}", SandglassBlock(
                    quarter, quarter, expansion=2.0, **kw))
        self.out_channels = 4 * quarter

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        x2 = self.conv2(x)
        x3 = x2
        for i in range(self.num_conv):
            x3 = getattr(self, f"conv3_{i}")(x3)
        x4 = x3
        for i in range(self.num_conv):
            x4 = getattr(self, f"conv4_{i}")(x4)
        return torch.cat([x1, x2, x3, x4], 1)


class _StagedBackbone(nn.Module):
    """Focus stem + 4 (stride-2 conv + block) stages, SPP before stage 4's
    block: the skeleton of CSPMobileNext and ECMNet."""

    # the Focus stem can take the augmentation's space-to-depth output
    # directly (layers.blocks.stem_input_s2d); the trainer feeds it so
    STEM_S2D = True

    def __init__(self, depths: Sequence[int] = (3, 9, 9, 3),
                 channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4"),
                 norm: str = "bn", act: str = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.outputs = tuple(outputs)
        self.stem = Focus(3, channels[0], ksize=3, **kw)
        widths = {"stem": channels[0]}
        width = channels[0]
        for i in range(4):
            ch = channels[i + 1]
            self.add_module(f"stage{i + 1}_down",
                            ConvBlock(width, ch, 3, stride=2, **kw))
            if i == 3:
                self.stage4_spp = SPPBottleneck(ch, ch, **kw)
            block = self.make_block(ch, depths[i], i == 3, **kw)
            self.add_module(f"stage{i + 1}_block", block)
            width = widths[f"stage{i + 1}"] = block.out_channels
        self.out_channels = [widths[k] for k in self.outputs]

    def make_block(self, in_channels: int, depth: int, last: bool,
                   **kw) -> nn.Module:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem(x)
        feats = {"stem": x}
        for i in range(4):
            x = getattr(self, f"stage{i + 1}_down")(x)
            if i == 3:
                x = self.stage4_spp(x)
            x = getattr(self, f"stage{i + 1}_block")(x)
            feats[f"stage{i + 1}"] = x
        return [feats[k] for k in self.outputs]


class CSPMobileNext(_StagedBackbone):
    def make_block(self, in_channels, depth, last, **kw):
        return MobileCSPLayer(in_channels, num_bottle=depth,
                              shortcut=not last, **kw)


class ECMNet(_StagedBackbone):
    def make_block(self, in_channels, depth, last, **kw):
        return ELANSandglassLayer(in_channels, num_bottle=depth, **kw)


# ------------------------------------------------------------- MobileNetV3

class SEModule(nn.Module):
    """Squeeze-excite with a hard-sigmoid gate: the spatial mean (on a band
    of rows, the whole map's: `blocks.spatial_mean`) through two 1x1
    ConvBlocks (bn + relu, bn + hsigmoid), times the input. The
    BatchNorms see a [B, C, 1, 1] map: in train mode, B values a channel
    (under `parallel: {spatial: S}` every spatial rank holds it whole, and
    the global BN counts each row S times: the same biased statistics)."""

    def __init__(self, channels: int, reduction: int = 4,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.fc1 = ConvBlock(channels, channels // reduction, 1, norm="bn",
                             act="relu", dtype=dtype)
        self.fc2 = ConvBlock(channels // reduction, channels, 1, norm="bn",
                             act="hsigmoid", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc2(self.fc1(spatial_mean(x)))


class MNV3Block(nn.Module):
    """Inverted residual: 1x1 expand -> dw kxk -> optional SE -> 1x1
    project, the residual when stride 1 and the widths match."""

    def __init__(self, in_channels: int, ksize: int, expand: int,
                 out_channels: int, act: str, use_se: bool, stride: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.expand = ConvBlock(in_channels, expand, 1, norm="bn", act=act,
                                dtype=dtype)
        self.dw = ConvBlock(expand, expand, ksize, stride, groups=expand,
                            norm="bn", act=act, dtype=dtype)
        self.se = SEModule(expand, dtype=dtype) if use_se else None
        self.project = ConvBlock(expand, out_channels, 1, norm="bn",
                                 act=None, dtype=dtype)
        self.use_add = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dw(self.expand(x))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return y + x if self.use_add else y


# (ksize, in, expand, out, act, se, stride) — the reference's
# mobilenetv3.py:30-52 (small) and :99-125 (large)
_MNV3_SMALL = (
    ((3, 16, 16, 16, "relu", True, 2),),
    ((3, 16, 72, 24, "relu", False, 2), (3, 24, 88, 24, "relu", False, 1)),
    ((5, 24, 96, 40, "hswish", True, 2), (5, 40, 240, 40, "hswish", True, 1),
     (5, 40, 240, 40, "hswish", True, 1), (5, 40, 120, 48, "hswish", True, 1),
     (5, 48, 144, 48, "hswish", True, 1)),
    ((5, 48, 288, 96, "hswish", True, 2), (5, 96, 576, 96, "hswish", True, 1),
     (5, 96, 576, 96, "hswish", True, 1)),
)
_MNV3_LARGE = (
    ((3, 16, 16, 16, "relu", False, 1), (3, 16, 64, 24, "relu", False, 2),
     (3, 24, 72, 24, "relu", False, 1)),
    ((5, 24, 72, 40, "relu", True, 2), (5, 40, 120, 40, "relu", True, 1),
     (5, 40, 120, 40, "relu", True, 1)),
    ((3, 40, 240, 80, "hswish", False, 2), (3, 80, 200, 80, "hswish", False, 1),
     (3, 80, 184, 80, "hswish", False, 1), (3, 80, 184, 80, "hswish", False, 1)),
    ((3, 80, 480, 112, "hswish", True, 1), (3, 112, 672, 112, "hswish", True, 1),
     (5, 112, 672, 160, "hswish", True, 1), (5, 160, 672, 160, "hswish", True, 2),
     (5, 160, 960, 160, "hswish", True, 1)),
)


class MobileNetV3(nn.Module):
    """MobileNetV3 S/L multi-scale backbone: a 3x3 stride-2 hswish stem (no
    Focus), then the table's four stages at strides 4-32; out widths small
    (24, 48, 96), large (40, 80, 160) for stage2-4. Its norm and
    activations are the table's: the config's `norm` / `act` are not read,
    as in the JAX package."""

    def __init__(self, size: str = "small",
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4"),
                 dtype: torch.dtype | None = None):
        super().__init__()
        table = _MNV3_SMALL if size == "small" else _MNV3_LARGE
        self.outputs = tuple(outputs)
        self.stem = ConvBlock(3, 16, 3, stride=2, norm="bn", act="hswish",
                              dtype=dtype)
        widths = {"stem": 16}
        width = 16
        self.stages = []
        for si, stage in enumerate(table):
            names = []
            for bi, (k, _in, exp, out, act, se, s) in enumerate(stage):
                name = f"stage{si + 1}_b{bi}"
                self.add_module(name, MNV3Block(width, k, exp, out, act, se,
                                                s, dtype=dtype))
                names.append(name)
                width = out
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
