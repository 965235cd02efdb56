"""The plug-in attention registry, port of `pl_yolo_tpu/layers/attention.py`
and its four companions (`attention_extra`, `attention_more`,
`attention_seq`, `attention_spatial`).

Every module keeps the JAX registry's contract of a map in and a map out,
[B,H,W,C] (NHWC) both, and only `residual` changes the shape (it scores
classes, [B, num_classes]); `skff` takes a list of maps. Torch modules
need their input widths at build time, where flax infers them at init, so
every class takes the map's `channels` first, and the five whose
parameters depend on the map's size (`aft`, `danet`, `moa`, `gfnet`,
`vip`) take `size=(H, W)` too. The submodule and parameter names are the
flax names, and free parameters keep their JAX shapes, so the bridge maps
a flax tree by a rename.

A bare flax `nn.BatchNorm` has eps 1e-5 and momentum 0.99 (torch 0.01),
not the conv blocks' 1e-3 / 0.97 (`attention_common.bare_batch_norm`).
CoordAtt's and TripletAttention's normalise by their running statistics in
train mode too (`attention_common.FrozenBatchNorm`), as the JAX modules
pass `use_running_average=True`.

`ATTENTION[name]` is the class; `build_attention(name, channels, size,
**kwargs)` builds one, None for `None` / "none".
"""

from __future__ import annotations

import inspect

import torch
import torch.nn.functional as F
from torch import nn

from .attention_common import FrozenBatchNorm, conv_nhwc
from .blocks import SameConv2d


class SELayer(nn.Module):
    """Squeeze-and-excitation."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.relu(self.fc1(x.mean((1, 2)))))
        return x * torch.sigmoid(s)[:, None, None, :]


class ECALayer(nn.Module):
    """Efficient channel attention: a 1-D conv over the channel profile."""

    def __init__(self, channels: int, ksize: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, ksize, padding=ksize // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.conv(x.mean((1, 2))[:, None, :])[:, 0]     # conv over C
        return x * torch.sigmoid(s)[:, None, None, :]


class SALayer(nn.Module):
    """Spatial attention: a conv of the channel-pooled mean and max maps."""

    def __init__(self, channels: int, ksize: int = 7):
        super().__init__()
        self.conv = SameConv2d(2, 1, ksize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.cat([x.mean(-1, keepdim=True),
                       x.amax(-1, keepdim=True)], dim=-1)
        return x * torch.sigmoid(conv_nhwc(self.conv, s))


class CBAM(nn.Module):
    """Channel attention (one MLP on the average and the max) then
    spatial attention."""

    def __init__(self, channels: int, reduction: int = 16, ksize: int = 7):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)
        self.spatial = SALayer(channels, ksize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(s):
            return self.fc2(F.relu(self.fc1(s)))
        g = mlp(x.mean((1, 2))) + mlp(x.amax((1, 2)))
        return self.spatial(x * torch.sigmoid(g)[:, None, None, :])


class CoordAtt(nn.Module):
    """Coordinate attention: H- and W-direction pooling through a shared
    bottleneck (1-D convs, a BatchNorm on its running statistics, hard
    swish), one sigmoid gate a direction."""

    def __init__(self, channels: int, reduction: int = 32):
        super().__init__()
        hidden = max(channels // reduction, 8)
        self.conv1 = nn.Conv1d(channels, hidden, 1)
        self.bn = FrozenBatchNorm(hidden)
        self.conv_h = nn.Conv1d(hidden, channels, 1)
        self.conv_w = nn.Conv1d(hidden, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[1]
        y = torch.cat([x.mean(2), x.mean(1)], dim=1)        # [B, H+W, C]
        y = F.hardswish(self.bn(self.conv1(y.transpose(1, 2))))
        ah = torch.sigmoid(self.conv_h(y[:, :, :h])).transpose(1, 2)
        aw = torch.sigmoid(self.conv_w(y[:, :, h:])).transpose(1, 2)
        return x * ah[:, :, None, :] * aw[:, None, :, :]


class SimAM(nn.Module):
    """Parameter-free attention by neuron energy."""

    def __init__(self, channels: int, lam: float = 1e-4):
        super().__init__()
        self.lam = lam

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1] * x.shape[2] - 1
        d = (x - x.mean((1, 2), keepdim=True)) ** 2
        v = d.sum((1, 2), keepdim=True) / n
        return x * torch.sigmoid(d / (4 * (v + self.lam)) + 0.5)


class ShuffleAttention(nn.Module):
    """Grouped channel and spatial attention, then a channel shuffle; the
    free parameters [1,1,1,g,cg/2] as in the JAX package."""

    def __init__(self, channels: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        shape = (1, 1, 1, groups, channels // groups // 2)
        self.cweight = nn.Parameter(torch.zeros(shape))
        self.cbias = nn.Parameter(torch.ones(shape))
        self.sweight = nn.Parameter(torch.zeros(shape))
        self.sbias = nn.Parameter(torch.ones(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g = self.groups
        cg = c // g
        xg = x.reshape(b, h, w, g, cg)
        x0, x1 = xg[..., :cg // 2], xg[..., cg // 2:]
        s = x0.mean((1, 2), keepdim=True)
        x0 = x0 * torch.sigmoid(s * self.cweight + self.cbias)
        mu = x1.mean((1, 2), keepdim=True)
        var = x1.var((1, 2), correction=0, keepdim=True)
        sn = (x1 - mu) * torch.rsqrt(var + 1e-5)
        x1 = x1 * torch.sigmoid(sn * self.sweight + self.sbias)
        out = torch.cat([x0, x1], dim=-1)                   # [b,h,w,g,cg]
        return out.transpose(3, 4).reshape(b, h, w, c)


class GAM(nn.Module):
    """Global attention: an MLP channel gate, then a 7x7-conv spatial gate."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)
        self.conv1 = SameConv2d(channels, hidden, 7)
        self.conv2 = SameConv2d(hidden, channels, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * torch.sigmoid(self.fc2(F.relu(self.fc1(x))))
        s = self.conv2(F.relu(self.conv1(x.permute(0, 3, 1, 2))))
        return x * torch.sigmoid(s.permute(0, 2, 3, 1))


class SKFF(nn.Module):
    """Selective kernel feature fusion: a softmax over `branches` maps of
    one shape, called with their list (flax counts them at init)."""

    def __init__(self, channels: int, branches: int = 2, reduction: int = 8):
        super().__init__()
        hidden = max(channels // reduction, 4)
        self.branches = branches
        self.fc = nn.Linear(channels, hidden)
        for i in range(branches):
            setattr(self, f"sel{i}", nn.Linear(hidden, channels))

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        if len(feats) != self.branches:
            raise ValueError(f"SKFF built for {self.branches} maps, given "
                             f"{len(feats)}")
        z = F.relu(self.fc(sum(feats).mean((1, 2))))
        logits = [getattr(self, f"sel{i}")(z) for i in range(self.branches)]
        w = torch.softmax(torch.stack(logits, dim=1), dim=1)  # [B, n, C]
        return sum(f * w[:, i][:, None, None, :] for i, f in enumerate(feats))


from .attention_extra import (ACmix, DAttention, HaloAttention,  # noqa: E402
                              MobileViTAttention, OutlookAttention)
from .attention_more import (BAM, SGE, CoTAttention,  # noqa: E402
                             ExternalAttention, ParNetAttention,
                             PolarizedSelfAttention, S2Attention,
                             SKAttention, TripletAttention)
from .attention_seq import (EMSA, AFTFull, DAModule,  # noqa: E402
                            DoubleAttention, MobileViTv2Attention,
                            MUSEAttention, ScaledDotProductAttention,
                            SimplifiedSelfAttention, UFOAttention)
from .attention_spatial import (AxialAttention, CABlock,  # noqa: E402
                                CoAtNetBlock, CrissCrossAttention,
                                CrossformerAttention, GFNetBlock,
                                MOAGlobalAttention, MultiSpectralAttention,
                                PyramidSplitAttention, ResidualAttention,
                                SequentialPolarizedSelfAttention,
                                ViPAttention)

ATTENTION = {
    "se": SELayer,
    "eca": ECALayer,
    "sa": SALayer,
    "cbam": CBAM,
    "coordatt": CoordAtt,
    "simam": SimAM,
    "shuffle": ShuffleAttention,
    "gam": GAM,
    "skff": SKFF,
    "halo": HaloAttention,
    "outlook": OutlookAttention,
    "mobilevit": MobileViTAttention,
    "acmix": ACmix,
    "dat": DAttention,
    "bam": BAM,
    "triplet": TripletAttention,
    "sk": SKAttention,
    "external": ExternalAttention,
    "psa": PolarizedSelfAttention,
    "sge": SGE,
    "cot": CoTAttention,
    "parnet": ParNetAttention,
    "s2": S2Attention,
    # token-style zoo (attention_seq.py)
    "self": ScaledDotProductAttention,
    "simself": SimplifiedSelfAttention,
    "ufo": UFOAttention,
    "muse": MUSEAttention,
    "aft": AFTFull,
    "mobilevitv2": MobileViTv2Attention,
    "emsa": EMSA,
    "danet": DAModule,
    "a2": DoubleAttention,
    # spatially-structured zoo (attention_spatial.py)
    "crisscross": CrissCrossAttention,
    "axial": AxialAttention,
    "crossformer": CrossformerAttention,
    "moa": MOAGlobalAttention,
    "gfnet": GFNetBlock,
    "vip": ViPAttention,
    "epsa": PyramidSplitAttention,
    "psa_seq": SequentialPolarizedSelfAttention,
    "coatnet": CoAtNetBlock,
    "ca_block": CABlock,
    "fca": MultiSpectralAttention,
    "residual": ResidualAttention,  # NOT shape-preserving (see class doc)
}


def build_attention(name: str | None, channels: int | None = None,
                    size: tuple[int, int] | None = None, **kwargs):
    """name -> module instance for maps of `channels` (None / 'none' ->
    None); `size` (H, W) reaches only the classes whose parameters depend
    on it, which need it."""
    if name in (None, "none", False):
        return None
    if name not in ATTENTION:
        raise KeyError(f"Unknown attention '{name}'. Available: "
                       f"{sorted(ATTENTION)}")
    cls = ATTENTION[name]
    if "size" in inspect.signature(cls).parameters:
        if size is None:
            raise ValueError(f"attention '{name}' needs the map's size")
        kwargs["size"] = tuple(size)
    return cls(channels, **kwargs)
