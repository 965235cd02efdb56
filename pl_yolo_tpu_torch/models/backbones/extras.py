"""The extra backbones: EfficientRep, ResNet, ConvNeXt, GhostNet, VGG,
MobileNeXt, port of `pl_yolo_tpu/models/backbones/extras.py`.

Each is a multi-scale detection backbone of NCHW maps, returning the
stages its `outputs` name (stage2, stage3, stage4 at strides 8/16/32 by
default). The submodule names are the flax module names, so the bridge
maps a flax tree by a rename.

Under `dtype: bfloat16` the `ConvBlock`s compute in bf16, as the JAX
package's compute dtype reaches them; the bare flax layers compute in fp32
whatever it is: EfficientRep's RepConvs, the whole of ConvNeXt (bare convs,
LayerNorms and Dense layers), and GhostNet's squeeze-excite, whose fp32
gate makes the product fp32 until the next `ConvBlock` takes bf16 again.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers.blocks import (ConvBlock, LayerNorm, LayerNorm2d, SameConv2d,
                              apply_conv, max_pool, max_pool_same,
                              spatial_mean)
from ..necks.yolov7_neck import RepConv
from .eelan import max_pool_stride2
from .mobile import SandglassBlock

_STAGES = ("stage1", "stage2", "stage3", "stage4")


def _pick(by_name: dict, outputs: Sequence[str]) -> list:
    """The entries of `by_name` (maps or widths) that `outputs` names."""
    return [by_name[k] for k in outputs]


# ----------------------------------------------------------- EfficientRep

class SimSPPF(nn.Module):
    """Sequential SPP with ReLU: three chained 5x5 stride-1 max pools,
    concat, fuse."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 5,
                 dtype: torch.dtype | None = None):
        super().__init__()
        hidden = in_channels // 2
        kw = dict(norm="bn", act="relu", dtype=dtype)
        self.ksize = ksize
        self.cv1 = ConvBlock(in_channels, hidden, 1, **kw)
        self.cv2 = ConvBlock(4 * hidden, out_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        y1 = max_pool_same(x, self.ksize)
        y2 = max_pool_same(y1, self.ksize)
        y3 = max_pool_same(y2, self.ksize)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class EfficientRep(nn.Module):
    """RepVGG-block backbone: a rep stem, then 4 stages of (rep stride-2 +
    n rep blocks), SimSPPF at the end of stage 4."""

    def __init__(self, depths: Sequence[int] = (1, 2, 3, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4"),
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.depths, self.outputs = tuple(depths), tuple(outputs)
        self.stem = RepConv(3, channels[0], stride=2, act="relu")
        prev = channels[0]
        for i in range(4):
            ch = channels[i + 1]
            setattr(self, f"stage{i+1}_down",
                    RepConv(prev, ch, stride=2, act="relu"))
            for j in range(depths[i]):
                setattr(self, f"stage{i+1}_rep{j}",
                        RepConv(ch, ch, act="relu"))
            prev = ch
        self.stage4_sppf = SimSPPF(prev, prev, dtype=dtype)
        self.out_channels = _pick(
            {"stem": channels[0], **{s: channels[i + 1]
                                     for i, s in enumerate(_STAGES)}},
            self.outputs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = {}
        x = self.stem(x)
        feats["stem"] = x
        for i in range(4):
            x = getattr(self, f"stage{i+1}_down")(x)
            for j in range(self.depths[i]):
                x = getattr(self, f"stage{i+1}_rep{j}")(x)
            if i == 3:
                x = self.stage4_sppf(x)
            feats[f"stage{i+1}"] = x
        return _pick(feats, self.outputs)


# ----------------------------------------------------------------- ResNet

class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv1 = ConvBlock(in_channels, out_channels, 3, stride,
                               norm="bn", act="relu", dtype=dtype)
        self.conv2 = ConvBlock(out_channels, out_channels, 3, norm="bn",
                               act=None, dtype=dtype)
        self.down = (ConvBlock(in_channels, out_channels, 1, stride,
                               norm="bn", act=None, dtype=dtype)
                     if stride != 1 or in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.down is None else self.down(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class ResNet(nn.Module):
    """ResNet-18/34 style detection backbone: a 7x7 stride-2 stem and a
    3x3 stride-2 max pool (-inf padding 1), then 4 basic-block stages."""

    def __init__(self, depths: Sequence[int] = (2, 2, 2, 2),
                 channels: Sequence[int] = (64, 128, 256, 512),
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4"),
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.depths, self.outputs = tuple(depths), tuple(outputs)
        self.stem = ConvBlock(3, channels[0], 7, 2, norm="bn", act="relu",
                              dtype=dtype)
        prev = channels[0]
        for i in range(4):
            stride = 1 if i == 0 else 2
            for j in range(depths[i]):
                setattr(self, f"stage{i+1}_b{j}", BasicBlock(
                    prev, channels[i], stride if j == 0 else 1, dtype=dtype))
                prev = channels[i]
        self.out_channels = _pick(
            {"stem": channels[0], **{s: channels[i]
                                     for i, s in enumerate(_STAGES)}},
            self.outputs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = {}
        x = max_pool(self.stem(x), 3, 2, 1)
        feats["stem"] = x
        for i in range(4):
            for j in range(self.depths[i]):
                x = getattr(self, f"stage{i+1}_b{j}")(x)
            feats[f"stage{i+1}"] = x
        return _pick(feats, self.outputs)


# ---------------------------------------------------------------- ConvNeXt

class ConvNeXtBlock(nn.Module):
    """dw7x7 -> LN -> pw expand 4x (tanh GELU) -> pw reduce, the
    layer-scale residual (`gamma`, from 1e-6)."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = SameConv2d(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def init_weights_(self, gen: torch.Generator) -> None:
        # flax's zero conv bias and constant layer scale (build_model draws
        # the kernels and zeroes the dense biases)
        nn.init.zeros_(self.dwconv.bias)
        nn.init.constant_(self.gamma, self.layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # On an H100 cuDNN's depthwise 7x7 weight gradient of a
        # channels_last fp32 map took most of ConvNeXt-T's train step, and
        # PyTorch's own kernel for a contiguous map is faster there, where
        # cuDNN's channels_last forward is the faster one (chip_smoke.py
        # phase 18; PERF.md): where a backward may follow, the block
        # convolves a contiguous map
        if torch.is_grad_enabled():
            x = x.contiguous()
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        y = self.pwconv2(F.gelu(self.pwconv1(y), approximate="tanh"))
        return x + (y * self.gamma).permute(0, 3, 1, 2)


class ConvNeXt(nn.Module):
    """ConvNeXt-T style detection backbone: a 4x4 stride-4 patchify stem
    and LayerNorm, a LayerNorm and 2x2 stride-2 conv between stages, a
    LayerNorm on each stage it outputs. fp32 whatever the compute dtype."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 channels: Sequence[int] = (96, 192, 384, 768),
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4")):
        super().__init__()
        self.depths, self.outputs = tuple(depths), tuple(outputs)
        self.stem = SameConv2d(3, channels[0], 4, 4)
        self.stem_norm = LayerNorm2d(channels[0])
        self.out_channels = []
        for i in range(4):
            if i > 0:
                setattr(self, f"down_norm{i}", LayerNorm2d(channels[i - 1]))
                setattr(self, f"down{i}", SameConv2d(channels[i - 1],
                                                     channels[i], 2, 2))
            for j in range(depths[i]):
                setattr(self, f"stage{i}_b{j}", ConvNeXtBlock(channels[i]))
            # stage i has stride 4*2^i: stage1 = s4 .. stage4 = s32
            if f"stage{i + 1}" in self.outputs:
                setattr(self, f"out_norm{i}", LayerNorm2d(channels[i]))
                self.out_channels.append(channels[i])

    def init_weights_(self, gen: torch.Generator) -> None:
        for m in self.children():
            if isinstance(m, SameConv2d):
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outs = []
        x = self.stem_norm(self.stem(x))
        for i in range(4):
            if i > 0:
                x = getattr(self, f"down{i}")(
                    getattr(self, f"down_norm{i}")(x))
            for j in range(self.depths[i]):
                x = getattr(self, f"stage{i}_b{j}")(x)
            if f"stage{i + 1}" in self.outputs:
                outs.append(getattr(self, f"out_norm{i}")(x))
        return outs


# ----------------------------------------------------------------- GhostNet

class GhostModule(nn.Module):
    """A primary 1x1 conv and a cheap depthwise conv on its output,
    concatenated, cut to `out_channels`."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 dw_size: int = 3, act: str | None = "relu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        init = out_channels // 2
        self.out_channels = out_channels
        self.primary = ConvBlock(in_channels, init, ksize, norm="bn", act=act,
                                 dtype=dtype)
        self.cheap = ConvBlock(init, init, dw_size, groups=init, norm="bn",
                               act=act, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.primary(x)
        y2 = self.cheap(y1)
        return torch.cat([y1, y2], dim=1)[:, :self.out_channels]


class GhostBottleneck(nn.Module):
    """ghost -> (dw stride) -> optional SE (hard-sigmoid gate
    clip(s·0.2 + 0.5, 0, 1), two bare biased 1x1 convs in fp32) ->
    ghost-linear, plus the shortcut (dw + pw where the shape changes)."""

    def __init__(self, in_channels: int, hidden: int, out_channels: int,
                 dw_size: int = 3, stride: int = 1, use_se: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.stride, self.use_se = stride, use_se
        self.ghost1 = GhostModule(in_channels, hidden, dtype=dtype)
        if stride > 1:
            self.dw = ConvBlock(hidden, hidden, dw_size, stride,
                                groups=hidden, norm="bn", act=None,
                                dtype=dtype)
        if use_se:
            self.se_fc1 = nn.Conv2d(hidden, hidden // 4, 1)
            self.se_fc2 = nn.Conv2d(hidden // 4, hidden, 1)
        self.ghost2 = GhostModule(hidden, out_channels, act=None, dtype=dtype)
        self.identity = stride == 1 and in_channels == out_channels
        if not self.identity:
            self.sc_dw = ConvBlock(in_channels, in_channels, dw_size, stride,
                                   groups=in_channels, norm="bn", act=None,
                                   dtype=dtype)
            self.sc_pw = ConvBlock(in_channels, out_channels, 1, norm="bn",
                                   act=None, dtype=dtype)

    def init_weights_(self, gen: torch.Generator) -> None:
        # flax's zero biases (build_model draws the kernels)
        if self.use_se:
            nn.init.zeros_(self.se_fc1.bias)
            nn.init.zeros_(self.se_fc2.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ghost1(x)
        if self.stride > 1:
            y = self.dw(y)
        if self.use_se:
            # flax promotes a bf16 input and fp32 params to fp32
            dtype = torch.promote_types(y.dtype, self.se_fc1.weight.dtype)
            s = spatial_mean(y).to(dtype)
            s = apply_conv(self.se_fc2, F.relu(apply_conv(self.se_fc1, s)))
            y = y * torch.clamp(s * 0.2 + 0.5, 0.0, 1.0)
        y = self.ghost2(y)
        if self.identity:
            return y + x
        return y + self.sc_pw(self.sc_dw(x))


# GhostNet-1.0 layer table: (dw_size, hidden, out, se, stride) per stage
_GHOST_STAGES = (
    ((3, 16, 16, False, 1), (3, 48, 24, False, 2), (3, 72, 24, False, 1)),
    ((5, 72, 40, True, 2), (5, 120, 40, True, 1)),
    ((3, 240, 80, False, 2), (3, 200, 80, False, 1), (3, 184, 80, False, 1),
     (3, 184, 80, False, 1), (3, 480, 112, True, 1), (3, 672, 112, True, 1)),
    ((5, 672, 160, True, 2), (5, 960, 160, False, 1), (5, 960, 160, True, 1),
     (5, 960, 160, False, 1), (5, 960, 160, True, 1)),
)


class GhostNet(nn.Module):
    """GhostNet-1.0: a 3x3 stride-2 stem of 16, then `_GHOST_STAGES`."""

    def __init__(self, outputs: Sequence[str] = ("stage2", "stage3",
                                                 "stage4"),
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.outputs = tuple(outputs)
        self.stem = ConvBlock(3, 16, 3, 2, norm="bn", act="relu", dtype=dtype)
        prev, widths = 16, {"stem": 16}
        for si, stage in enumerate(_GHOST_STAGES):
            for bi, (k, hid, out, se, s) in enumerate(stage):
                setattr(self, f"stage{si+1}_b{bi}", GhostBottleneck(
                    prev, hid, out, dw_size=k, stride=s, use_se=se,
                    dtype=dtype))
                prev = out
            widths[f"stage{si+1}"] = prev
        self.out_channels = _pick(widths, self.outputs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = {}
        x = self.stem(x)
        feats["stem"] = x
        for si, stage in enumerate(_GHOST_STAGES):
            for bi in range(len(stage)):
                x = getattr(self, f"stage{si+1}_b{bi}")(x)
            feats[f"stage{si+1}"] = x
        return _pick(feats, self.outputs)


# --------------------------------------------------------------------- VGG

class VGG(nn.Module):
    """Plain VGG-style conv stack: conv-conv-pool (2x2 VALID) stages; stage
    i is channels[min(i + 1, len - 1)] wide."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512, 512),
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4"),
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.outputs = tuple(outputs)
        kw = dict(norm="bn", act="relu", dtype=dtype)
        self.stem_c1 = ConvBlock(3, channels[0], 3, **kw)
        self.stem_c2 = ConvBlock(channels[0], channels[0], 3, **kw)
        prev, widths = channels[0], {"stem": channels[0]}
        for i in range(4):
            ch = channels[min(i + 1, len(channels) - 1)]
            setattr(self, f"stage{i+1}_c1", ConvBlock(prev, ch, 3, **kw))
            setattr(self, f"stage{i+1}_c2", ConvBlock(ch, ch, 3, **kw))
            prev = widths[f"stage{i+1}"] = ch
        self.out_channels = _pick(widths, self.outputs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = {}
        x = max_pool_stride2(self.stem_c2(self.stem_c1(x)))
        feats["stem"] = x
        for i in range(4):
            x = getattr(self, f"stage{i+1}_c2")(
                getattr(self, f"stage{i+1}_c1")(x))
            x = max_pool_stride2(x)
            feats[f"stage{i+1}"] = x
        return _pick(feats, self.outputs)


# ------------------------------------------------------------- MobileNeXt

class MobileNeXt(nn.Module):
    """Plain sandglass-block backbone: a 3x3 stride-2 stem, then 4 stages
    of (3x3 stride-2 conv + sandglass blocks of expansion 2)."""

    def __init__(self, depths: Sequence[int] = (2, 2, 4, 2),
                 channels: Sequence[int] = (32, 64, 128, 256, 512),
                 outputs: Sequence[str] = ("stage2", "stage3", "stage4"),
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.depths, self.outputs = tuple(depths), tuple(outputs)
        kw = dict(norm="bn", act="silu", dtype=dtype)
        self.stem = ConvBlock(3, channels[0], 3, 2, **kw)
        prev = channels[0]
        for i in range(4):
            ch = channels[i + 1]
            setattr(self, f"stage{i+1}_down", ConvBlock(prev, ch, 3, 2, **kw))
            for j in range(depths[i]):
                setattr(self, f"stage{i+1}_b{j}",
                        SandglassBlock(ch, ch, expansion=2.0, dtype=dtype))
            prev = ch
        self.out_channels = _pick(
            {"stem": channels[0], **{s: channels[i + 1]
                                     for i, s in enumerate(_STAGES)}},
            self.outputs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = {}
        x = self.stem(x)
        feats["stem"] = x
        for i in range(4):
            x = getattr(self, f"stage{i+1}_down")(x)
            for j in range(self.depths[i]):
                x = getattr(self, f"stage{i+1}_b{j}")(x)
            feats[f"stage{i+1}"] = x
        return _pick(feats, self.outputs)
