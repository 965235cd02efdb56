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
does (`BatchNorm2d` below). `norm: ln` is flax's LayerNorm over the channels
(`LayerNorm2d`).

Rematerialisation (the model yaml's top-level `remat: true`): the CSP stage
layers the JAX package wraps in `nn.remat` run under `maybe_checkpoint`,
which recomputes their interiors in the backward pass instead of keeping
them; parameters and state_dict keys are unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import spatial, tensor
from ..parallel.mesh import (current_layout, global_batch_norm,
                             model_layout, norm_layout, spatial_layout,
                             use_layout)

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch momentum = 1 - flax momentum (0.97)
LN_EPS = 1e-6       # flax nn.LayerNorm's default

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
    Eval mode and the `state_dict` keys are the base class's. With
    `update_stats` false (the recompute of a checkpointed layer), train
    mode normalises by the batch and leaves the running statistics alone.
    Inside a train step whose norm group (`parallel.mesh.use_layout`, data
    x spatial) holds more than one rank the batch is the global one: the
    statistics come from every data rank's rows and every spatial rank's
    band (`parallel.mesh.global_batch_norm`), as GSPMD makes the JAX
    package's BatchNorm global."""

    def __init__(self, num_features: int, eps: float, momentum: float):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.update_stats = True
        # scratch for the batch's own statistics; not part of the state_dict
        self.register_buffer("batch_mean", torch.zeros(num_features),
                             persistent=False)
        self.register_buffer("batch_var", torch.ones(num_features),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        layout = norm_layout()
        if layout is not None:
            y, mean, var = global_batch_norm(x, self.weight, self.bias,
                                             self.eps, layout)
            if self.update_stats:
                with torch.no_grad():
                    self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                            self.momentum)
                    self.running_var.lerp_(var.to(self.running_var.dtype),
                                           self.momentum)
                    self.num_batches_tracked += 1
            return y
        # momentum 1 makes the fused op overwrite the scratch buffers with
        # the batch's mean and unbiased variance
        y = F.batch_norm(x, self.batch_mean, self.batch_var, self.weight,
                         self.bias, True, 1.0, self.eps)
        if not self.update_stats:
            return y
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(self.batch_mean, self.momentum)
            # (out of place: autograd holds the op's buffers for backward)
            self.running_var.lerp_(self.batch_var * ((n - 1) / n),
                                   self.momentum)
            self.num_batches_tracked += 1
        return y


class LayerNorm2d(nn.Module):
    """flax `nn.LayerNorm` over the channels of an NCHW tensor: eps 1e-6,
    `weight` (flax `scale`) and `bias` [C]; the statistics in fp32 (float64
    for a float64 input, as flax promotes them) as mean(x²) - mean(x)²
    (flax's fast variance, clamped at 0), the result in the input's
    dtype."""

    def __init__(self, num_features: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return ((xf - mean) * mul + self.bias[:, None, None]).to(x.dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis (the transformer backbones'
    tokens and NHWC maps): eps 1e-6 by default, `weight` (flax `scale`) and
    `bias`, the statistics in fp32 (float64 for a float64 input) as
    mean(x²) - mean(x)² clamped at 0, as `LayerNorm2d` computes them over
    the channels of an NCHW tensor."""

    def __init__(self, num_features: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class SameConv2d(nn.Conv2d):
    """A bare flax `nn.Conv` (its default padding 'SAME'): the input is
    padded so that the output has ceil(size / stride) rows and columns,
    the odd pixel of an uneven split at the bottom and right, as XLA pads
    (a 3x3 stride-2 conv on an even map pads 0 above and 1 below). On a
    band of rows (`parallel: {spatial}`) the split is the whole map's:
    the band takes its rows above and below as halo rows, zero beyond the
    image; a cout-sharded weight (`parallel: {model}`) runs as
    `parallel.tensor.conv2d` (`_conv_padded`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride, 0,
                         groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sp = spatial_layout()
        rows = x.shape[2] * (sp.spatial if sp is not None else 1)
        (top, bottom), (left, right) = (
            _same_pads(size, k, s) for size, k, s in zip(
                (rows, x.shape[3]), self.kernel_size, self.stride))
        if sp is not None:
            x = spatial.conv_input(x, self.kernel_size[0], self.stride[0],
                                   top, sp)
            top = bottom = 0
        if top or bottom or left or right:
            x = F.pad(x, [left, right, top, bottom])
        return _conv_padded(self, x, None, 0)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's 'SAME' (before, after) pads of a `size`-long axis for a
    window k, stride s."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _norms(norm: str | None, num_features: int
           ) -> tuple[nn.Module | None, nn.Module | None]:
    """(bn, ln) of a block: the module under its flax name, the other None."""
    if norm == "bn":
        return BatchNorm2d(num_features, BN_EPS, BN_MOMENTUM), None
    if norm == "ln":
        return None, LayerNorm2d(num_features)
    if norm in (None, "none"):
        return None, None
    raise ValueError(f"Unsupported norm: {norm}")


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype | None
          ) -> torch.Tensor:
    """`conv` applied in `dtype` (None: the input's dtype); params stay fp32.
    Inside a train step's layout a band of rows (`parallel: {spatial}`)
    first takes the halo rows its window reaches (`parallel.spatial`), and
    a conv whose cout is sharded (`parallel: {model}`) runs as
    `parallel.tensor.conv2d`."""
    sp = spatial_layout() if conv.kernel_size[0] > 1 else None
    if sp is None and not tensor.is_sharded(conv):
        if dtype is None:
            return conv(x)
        b = None if conv.bias is None else conv.bias.to(dtype)
        return F.conv2d(x.to(dtype), conv.weight.to(dtype), b, conv.stride,
                        conv.padding, conv.dilation, conv.groups)
    padding = conv.padding
    if sp is not None:
        x = spatial.conv_input(x, conv.kernel_size[0], conv.stride[0],
                               conv.padding[0], sp)
        padding = (0, conv.padding[1])
    return _conv_padded(conv, x, dtype, padding)


def _conv_padded(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype | None,
                 padding) -> torch.Tensor:
    """`conv`'s weight and bias on x (its halo rows already taken) with
    `padding`, in `dtype`; as `parallel.tensor.conv2d` where the weight
    holds a cout slice."""
    w, b = conv.weight, conv.bias
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    if tensor.is_sharded(conv):
        return tensor.conv2d(x, w, b, conv.stride, padding, conv.dilation,
                             conv.groups, model_layout())
    return F.conv2d(x, w, b, conv.stride, padding, conv.dilation,
                    conv.groups)


def apply_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A bare `nn.Conv2d` (a head's prediction conv) in its parameters'
    dtype, through `_conv`'s halo and cout-sharded routes inside a train
    step's layout."""
    return _conv(conv, x, None)


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
        self.bn, self.ln = _norms(norm, out_channels)
        self.act = get_activation(act)
        self.dtype = dtype

    def norm_act(self, x: torch.Tensor) -> torch.Tensor:
        """The block's normalization and activation of a conv output."""
        if self.bn is not None:
            x = self.bn(x)
        elif self.ln is not None:
            x = self.ln(x)
        return self.act(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm_act(_conv(self.conv, x, self.dtype))


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


# "The stem input is already space-to-depth'ed": `data.augment.
# device_augment(out_s2d=True)` emits the Focus stem's [B,H/2,W/2,4c] layout
# straight from its channel-major pool. Consumed by the first Focus called
# inside the context, so that only the stem skips its own space_to_depth
# (the JAX package's ambient flag, resolved there at trace time).
_PENDING_S2D_INPUT = [False]


class stem_input_s2d:
    """Context manager: the next Focus call inside receives pre-s2d input."""

    def __enter__(self):
        self._prev = _PENDING_S2D_INPUT[0]
        _PENDING_S2D_INPUT[0] = True
        return self

    def __exit__(self, *exc):
        _PENDING_S2D_INPUT[0] = self._prev
        return False


def _take_stem_s2d() -> bool:
    v = _PENDING_S2D_INPUT[0]
    _PENDING_S2D_INPUT[0] = False
    return v


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

    Under `stem_input_s2d()` the input already has the space_to_depth
    layout and only the 3x3 ConvBlock runs, in train and eval mode alike
    (a bf16 input is widened for an fp32 block). Otherwise, with
    `fused=True` and (ksize=3, stride=1), eval mode runs the exact
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
        if _take_stem_s2d():
            blk = self.conv
            return blk(x.to(blk.dtype or blk.conv.weight.dtype))
        if self.fused and not self.training:
            blk = self.conv
            w6, b = focus_kernel_6x6(blk.conv.weight), blk.conv.bias
            if blk.dtype is not None:
                x, w6 = x.to(blk.dtype), w6.to(blk.dtype)
                b = None if b is None else b.to(blk.dtype)
            return blk.norm_act(F.conv2d(x, w6, b, stride=2, padding=2))
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


class _Recompute:
    """Context of a checkpointed layer's recompute: the BatchNorms of
    `layer` leave their running statistics alone (its forward has already
    updated them once, as flax's `nn.remat` updates them once), and the
    layout the forward ran under (`parallel.mesh.use_layout`) is the
    ambient one again, whatever the backward pass runs under: a sharded
    conv then gathers its channels and a band takes its halo rows, in the
    order the forward took them on every rank."""

    def __init__(self, layer: nn.Module, layout):
        self.bns = [m for m in layer.modules() if isinstance(m, BatchNorm2d)]
        self.layout = use_layout(layout)

    def __enter__(self):
        self.layout.__enter__()
        for m in self.bns:
            m.update_stats = False

    def __exit__(self, *exc):
        for m in self.bns:
            m.update_stats = True
        return self.layout.__exit__(*exc)


def maybe_checkpoint(layer: nn.Module, x: torch.Tensor, remat: bool
                     ) -> torch.Tensor:
    """`layer(x)`, under `torch.utils.checkpoint` when `remat` and the layer
    trains with autograd on: the backward pass recomputes the layer's
    interior instead of keeping it (the JAX package's `maybe_remat`). The
    recompute runs under the layout of the step that recorded it and
    leaves the BatchNorm running statistics alone (`_Recompute`); the
    layers wrapped draw no random numbers, so no RNG state is kept."""
    if not (remat and layer.training and torch.is_grad_enabled()):
        return layer(x)
    layout = current_layout()
    return checkpoint(layer, x, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _Recompute(layer, layout)))


def max_pool_same(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Stride-1 max pool with SAME padding (-inf pad), NCHW; on a band of
    rows (`parallel: {spatial}`) with its halo rows."""
    return max_pool(x, ksize, 1, ksize // 2)


def max_pool(x: torch.Tensor, ksize: int, stride: int, pad: int
             ) -> torch.Tensor:
    """`F.max_pool2d(x, ksize, stride, pad)` (-inf pad), NCHW; on a band
    of rows (`parallel: {spatial}`) with the halo rows its window
    reaches."""
    sp = spatial_layout()
    if sp is not None:
        return spatial.max_pool(x, ksize, stride, pad, sp)
    return F.max_pool2d(x, ksize, stride, pad)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """A squeeze-excite's mean over the rows and columns of NCHW x,
    [B, C, 1, 1]; on a band of rows (`parallel: {spatial}`) the whole
    map's mean on every spatial rank (`parallel.spatial.band_mean`)."""
    sp = spatial_layout()
    if sp is not None:
        return spatial.band_mean(x, sp)
    return x.mean((2, 3), keepdim=True)


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


class SPPCSPC(nn.Module):
    """CSP-style SPP of the YOLOv7 neck: cv1 -> cv3 (3x3) -> cv4, pools,
    cv5 -> cv6 (3x3) on one branch, cv2 on the other, concat, cv7."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13),
                 norm: str | None = "bn", act: str | None = "silu",
                 dtype: torch.dtype | None = None):
        super().__init__()
        c2 = out_channels
        kw = dict(norm=norm, act=act, dtype=dtype)
        self.kernel_sizes = tuple(kernel_sizes)
        self.cv1 = ConvBlock(in_channels, c2, 1, **kw)
        self.cv3 = ConvBlock(c2, c2, 3, **kw)
        self.cv4 = ConvBlock(c2, c2, 1, **kw)
        self.cv5 = ConvBlock(c2 * (len(self.kernel_sizes) + 1), c2, 1, **kw)
        self.cv6 = ConvBlock(c2, c2, 3, **kw)
        self.cv2 = ConvBlock(in_channels, c2, 1, **kw)
        self.cv7 = ConvBlock(2 * c2, c2, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.cv4(self.cv3(self.cv1(x)))
        pools = [max_pool_same(x1, ks) for ks in self.kernel_sizes]
        y1 = self.cv6(self.cv5(torch.cat([x1] + pools, dim=1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], dim=1))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
