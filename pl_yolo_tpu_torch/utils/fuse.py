"""Deploy-time branch fusion: conv + BN folding and the RepConv collapse,
port of `pl_yolo_tpu/utils/fuse.py` for the port's modules.

`fuse_conv_bn` folds BatchNorm statistics into a conv kernel and bias;
`fuse_repconv` collapses a `RepConv`'s (3x3 + BN, 1x1 + BN, identity BN)
branches into one biased 3x3 conv, and `fuse_repconvs_` swaps every RepConv
of a model for that conv, which gives the same eval output. `fold_bn_`
folds the BatchNorm of every `ConvBlock` into its conv, as the JAX
package's exporters fold them before writing a graph (an ONNX runtime then
needs no BatchNormalization).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers.blocks import BN_EPS, ConvBlock
from ..models.necks.yolov7_neck import RepConv


def fuse_conv_bn(weight: torch.Tensor, bn_scale: torch.Tensor,
                 bn_bias: torch.Tensor, bn_mean: torch.Tensor,
                 bn_var: torch.Tensor, eps: float = BN_EPS
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold BN(y) = scale*(y-mean)/sqrt(var+eps)+bias into a conv kernel
    [cout, cin, kh, kw] (OIHW). Returns (kernel', bias')."""
    factor = bn_scale / torch.sqrt(bn_var + eps)
    return weight * factor[:, None, None, None], bn_bias - bn_mean * factor


def _fuse(conv_weight: torch.Tensor, bn: nn.BatchNorm2d):
    return fuse_conv_bn(conv_weight, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var, bn.eps)


@torch.no_grad()
def fuse_repconv(m: RepConv) -> tuple[torch.Tensor, torch.Tensor]:
    """The (3x3 kernel, bias) of one conv equal to `m` in eval mode: the
    1x1 kernel padded to 3x3, the identity a 3x3 kernel with 1 at the
    centre of each channel's own tap."""
    k3, b3 = _fuse(m.rbr_dense_conv.weight, m.rbr_dense_bn)
    k1, b1 = _fuse(m.rbr_1x1_conv.weight, m.rbr_1x1_bn)
    kernel, bias = k3 + F.pad(k1, (1, 1, 1, 1)), b3 + b1
    if m.rbr_identity is not None:
        cin = kernel.shape[1]
        ident = torch.zeros_like(k3)
        idx = torch.arange(cin, device=k3.device)
        ident[idx, idx, 1, 1] = 1.0
        ki, bi = _fuse(ident, m.rbr_identity)
        kernel, bias = kernel + ki, bias + bi
    return kernel, bias


class FusedRepConv(nn.Module):
    """A RepConv after `fuse_repconv`: one biased 3x3 conv, then the
    activation (fp32, as RepConv)."""

    def __init__(self, m: RepConv):
        super().__init__()
        kernel, bias = fuse_repconv(m)
        conv = m.rbr_dense_conv
        self.conv = nn.Conv2d(conv.in_channels, conv.out_channels, 3,
                              conv.stride, 1, bias=True).to(kernel.device)
        with torch.no_grad():
            self.conv.weight.copy_(kernel)
            self.conv.bias.copy_(bias)
        self.act = m.act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(
            x.to(torch.promote_types(x.dtype, torch.float32))))


def fuse_repconvs_(module: nn.Module) -> nn.Module:
    """Replace every RepConv inside `module` by its FusedRepConv, in place
    (for deployment: the eval output stays the same); returns `module`."""
    for name, child in list(module.named_children()):
        if isinstance(child, RepConv):
            setattr(module, name, FusedRepConv(child))
        else:
            fuse_repconvs_(child)
    return module


@torch.no_grad()
def fold_bn_(module: nn.Module) -> nn.Module:
    """Fold the BatchNorm of every `ConvBlock` inside `module` into its
    conv, in place: the conv takes the folded kernel and a bias, and the
    block's `bn` becomes None (the stem's `Focus` folds through its
    `ConvBlock`). For an fp32 module in eval mode, whose output stays the
    same up to rounding; a RepConv is folded by `fuse_repconvs_` first.
    Returns `module`."""
    if module.training:
        raise ValueError("fold_bn_ folds the running statistics of an "
                         "eval-mode module; call .eval() first")
    for m in module.modules():
        if isinstance(m, ConvBlock) and m.bn is not None:
            kernel, bias = _fuse(m.conv.weight, m.bn)  # the conv has no bias
            m.conv.weight.copy_(kernel)
            m.conv.bias = nn.Parameter(bias)
            m.bn = None
    return module
