"""Core layer library: conv blocks, CSP layers, SPP, as torch modules.

Port of `pl_yolo_tpu/layers/blocks.py`. Modules run NCHW inside; the
submodule attribute names are the flax module names (`conv`, `bn`, `m0`,
`dconv`, `pconv`, ...), so a flax param path maps to a torch state_dict key
by a rename (see `pl_yolo_tpu_torch.bridge`).

Mixed precision: a module built with `dtype=torch.bfloat16` runs its conv
and BatchNorm in that dtype while its parameters stay fp32, as the JAX
package does under the model yaml's `dtype:` key. In the JAX package that
key is ambient global state; here it is passed to each module at build time.

BatchNorm uses eps=1e-3 and running-average momentum 0.03 (flax 0.97), and
in train mode keeps the *biased* batch variance in `running_var`, as flax
does (`BatchNorm2d` below).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch momentum = 1 - flax momentum (0.97)

_DTYPES = {None: None, "float32": None, "fp32": None,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def compute_dtype(name: str | None) -> torch.dtype | None:
    """The model yaml's `dtype:` value -> torch compute dtype (None = fp32)."""
    if name not in _DTYPES:
        raise ValueError(f"Unsupported compute dtype: {name}")
    return _DTYPES[name]


def get_activation(name: str | None = "silu") -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation factory (same names and slopes as the JAX package)."""
    if name is None or name == "none" or name is False:
        return lambda x: x
    acts = {
        "silu": F.silu,
        "relu": F.relu,
        "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.1),
        "hswish": F.hardswish,
        "hsigmoid": F.hardsigmoid,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu default
        "sigmoid": torch.sigmoid,
        "identity": lambda x: x,
    }
    if name not in acts:
        raise ValueError(f"Unsupported activation: {name}")
    return acts[name]


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train mode keeps flax's running statistics:
    the batch is normalised with its biased variance (as torch does), and
    `running_var` takes that same biased variance, where torch would store
    the unbiased one (a factor n/(n-1)). `running <- (1-momentum)*running +
    momentum*batch`; the statistics are fp32 whatever the compute dtype.
    Eval mode and the `state_dict` keys are the base class's."""

    def __init__(self, num_features: int, eps: float, momentum: float):
        super().__init__(num_features, eps=eps, momentum=momentum)
        # scratch for the batch's own statistics; not part of the state_dict
        self.register_buffer("batch_mean", torch.zeros(num_features),
                             persistent=False)
        self.register_buffer("batch_var", torch.ones(num_features),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # momentum 1 makes the fused op overwrite the scratch buffers with
        # the batch's mean and unbiased variance
        y = F.batch_norm(x, self.batch_mean, self.batch_var, self.weight,
                         self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(self.batch_mean, self.momentum)
            # (out of place: autograd holds the op's buffers for backward)
            self.running_var.lerp_(self.batch_var * ((n - 1) / n),
                                   self.momentum)
            self.num_batches_tracked += 1
        return y


def _norm(norm: str | None, num_features: int) -> nn.Module | None:
    if norm == "bn":
        return BatchNorm2d(num_features, BN_EPS, BN_MOMENTUM)
    if norm in (None, "none"):
        return None
    raise ValueError(f"Unsupported norm: {norm}")


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype | None
          ) -> torch.Tensor:
    """`conv` applied in `dtype` (None: the input's dtype); params stay fp32."""
    if dtype is None:
        return conv(x)
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), b, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class ConvBlock(nn.Module):
    """Conv2D -> normalization -> activation. The JAX package lowers a 1x1
    stride-1 conv through `Conv1x1` (a dot_general); its kernel is the same
    [1,1,cin,cout] param, so here it is an ordinary 1x1 `nn.Conv2d`."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 stride: int = 1, groups: int = 1, norm: str | None = "bn",
                 act: str | None = "silu", dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                              (ksize - 1) // 2, groups=groups, bias=False)
        self.bn = _norm(norm, out_channels)
        self.act = get_activation(act)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv(self.conv, x, self.dtype)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class DWConvBlock(nn.Module):
    """Depthwise kxk + pointwise 1x1 conv pair."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 3,
                 stride: int = 1, norm: str | None = "bn",
                 act: str | None = "silu", dtype: torch.dtype | None = None):
        super().__init__()
        self.dconv = ConvBlock(in_channels, in_channels, ksize, stride,
                               groups=in_channels, norm=norm, act=act,
                               dtype=dtype)
        self.pconv = ConvBlock(in_channels, out_channels, 1, 1, norm=norm,
                               act=act, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pconv(self.dconv(x))


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """2x2 space-to-depth of an NCHW tensor, channel q = px*2c + py*c + ch
    (column parity before row parity, as the JAX package's NHWC form). A
    channels_last input (the detector's permuted NHWC images) gives a
    channels_last output in one copy, so that the convs and BatchNorms
    behind it stay on their channels_last kernels."""
    b, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1)
    if nhwc.is_contiguous() and not x.is_contiguous():
        y = nhwc.reshape(b, h // 2, 2, w // 2, 2, c)  # (b, h2, py, w2, px, c)
        y = y.permute(0, 1, 3, 4, 2, 5)               # (b, h2, w2, px, py, c)
        return y.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)     # (b, c, h2, py, w2, px)
    x = x.permute(0, 5, 3, 1, 2, 4)                # (b, px, py, c, h2, w2)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def focus_kernel_6x6(weight: torch.Tensor) -> torch.Tensor:
    """[o, 4c, 3, 3] s2d+3x3 kernel -> the equivalent [o, c, 6, 6] kernel of
    a stride-2, pad-2 conv on the raw input: W6[o, ch, 2ky+py, 2kx+px] =
    w[o, px*2c + py*c + ch, ky, kx]."""
    o, c4 = weight.shape[:2]
    c = c4 // 4
    w = weight.reshape(o, 2, 2, c, 3, 3)           # (o, px, py, c, ky, kx)
    w = w.permute(0, 3, 4, 2, 5, 1)                # (o, c, ky, py, kx, px)
    return w.reshape(o, c, 6, 6)


class Focus(nn.Module):
    """Space-to-depth stem on one param tree (`conv.conv.weight`, 3x3x4c).

    With `fused=True` and (ksize=3, stride=1), eval mode runs the exact
    6x6-stride-2 reparameterization on the raw input; train mode, and
    `fused=False`, run space_to_depth then the 3x3 ConvBlock."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 stride: int = 1, norm: str | None = "bn",
                 act: str | None = "silu", fused: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = ConvBlock(4 * in_channels, out_channels, ksize, stride,
                              norm=norm, act=act, dtype=dtype)
        self.fused = fused and ksize == 3 and stride == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and not self.training:
            blk = self.conv
            w6 = focus_kernel_6x6(blk.conv.weight)
            if blk.dtype is not None:
                x, w6 = x.to(blk.dtype), w6.to(blk.dtype)
            y = F.conv2d(x, w6, stride=2, padding=2)
            if blk.bn is not None:
                y = blk.bn(y)
            return blk.act(y)
        return self.conv(space_to_depth(x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 residual bottleneck."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, norm: str | None = "bn",
                 act: str | None = "silu", dtype: torch.dtype | None = None):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvBlock(in_channels, hidden, 1, 1, norm=norm, act=act,
                               dtype=dtype)
        conv2 = DWConvBlock if depthwise else ConvBlock
        self.conv2 = conv2(hidden, out_channels, 3, 1, norm=norm, act=act,
                           dtype=dtype)
        self.use_add = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """Cross-stage-partial layer: two 1x1 branches, `num_bottle` bottlenecks
    on the first, concat, fuse with a 1x1."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_bottle: int = 1, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False,
                 norm: str | None = "bn", act: str | None = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        hidden = int(out_channels * expansion)
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.conv1 = ConvBlock(in_channels, hidden, 1, **kw)
        self.conv2 = ConvBlock(in_channels, hidden, 1, **kw)
        self.num_bottle = num_bottle
        for i in range(num_bottle):
            self.add_module(f"m{i}", Bottleneck(
                hidden, hidden, shortcut=shortcut, expansion=1.0,
                depthwise=depthwise, **kw))
        self.conv3 = ConvBlock(2 * hidden, out_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        x2 = self.conv2(x)
        for i in range(self.num_bottle):
            x1 = getattr(self, f"m{i}")(x1)
        return self.conv3(torch.cat([x1, x2], dim=1))


def max_pool_same(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Stride-1 max pool with SAME padding (-inf pad), NCHW."""
    return F.max_pool2d(x, ksize, stride=1, padding=ksize // 2)


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling. `conv2` has no norm, as in the reference."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13),
                 norm: str | None = "bn", act: str | None = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        hidden = in_channels // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = ConvBlock(in_channels, hidden, 1, norm=norm, act=act,
                               dtype=dtype)
        self.conv2 = ConvBlock(hidden * (len(self.kernel_sizes) + 1),
                               out_channels, 1, norm=None, act=act,
                               dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        pools = [max_pool_same(x, ks) for ks in self.kernel_sizes]
        return self.conv2(torch.cat([x] + pools, dim=1))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
