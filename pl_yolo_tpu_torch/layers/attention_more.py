"""Mid-weight attention plug-ins: BAM, Triplet, SK, External, Polarized
(parallel PSA), SGE, CoT, ParNet, S2-MLP, port of
`pl_yolo_tpu/layers/attention_more.py`. NHWC in and out (see
`layers.attention`). BAM, SK, CoT and ParNet train their BatchNorms
(`module.train()`, flax's `train=True`); Triplet's stay on their running
statistics."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention_common import FrozenBatchNorm, bare_batch_norm
from .blocks import LayerNorm, SameConv2d


class BAM(nn.Module):
    """Bottleneck attention, x · (1 + sigmoid(channel + spatial)): the
    channel branch GAP -> `num_layers` x (Dense + BN + ReLU) -> Dense, the
    spatial branch 1x1 reduce -> two dilated 3x3 convs -> 1x1 to one map."""

    def __init__(self, channels: int, reduction: int = 16,
                 num_layers: int = 3, dia_val: int = 2):
        super().__init__()
        red = max(channels // reduction, 1)
        self.num_layers = num_layers
        prev = channels
        for i in range(num_layers):
            setattr(self, f"ca_fc{i}", nn.Linear(prev, red))
            setattr(self, f"ca_bn{i}", bare_batch_norm(red))
            prev = red
        self.ca_out = nn.Linear(red, channels)
        self.sa_reduce = nn.Conv2d(channels, red, 1)
        self.sa_bn0 = bare_batch_norm(red)
        for i in range(2):
            # 'SAME' at stride 1 with dilation d pads d on each side
            setattr(self, f"sa_conv{i}", nn.Conv2d(
                red, red, 3, padding=dia_val, dilation=dia_val))
            setattr(self, f"sa_bn{i + 1}", bare_batch_norm(red))
        self.sa_out = nn.Conv2d(red, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean((1, 2))
        for i in range(self.num_layers):
            s = getattr(self, f"ca_fc{i}")(s)
            s = F.relu(getattr(self, f"ca_bn{i}")(s[:, :, None, None]))
            s = s[:, :, 0, 0]
        s = self.ca_out(s)[:, None, None, :]
        t = F.relu(self.sa_bn0(self.sa_reduce(x.permute(0, 3, 1, 2))))
        for i in range(2):
            t = F.relu(getattr(self, f"sa_bn{i + 1}")(
                getattr(self, f"sa_conv{i}")(t)))
        t = self.sa_out(t).permute(0, 2, 3, 1)
        return x * (1.0 + torch.sigmoid(s + t))


class TripletAttention(nn.Module):
    """Three branches, each a Z-pool (max and mean over one axis) -> 7x7
    conv -> BatchNorm (no scale or bias, on its running statistics) ->
    sigmoid gate, averaged; the rotations are transposes of the NHWC map."""

    def __init__(self, channels: int):
        super().__init__()
        for name in ("cw", "hc", "hw"):
            setattr(self, name, SameConv2d(2, 1, 7, bias=False))
            setattr(self, name + "_bn", FrozenBatchNorm(1, affine=False))

    def _gate(self, y: torch.Tensor, name: str) -> torch.Tensor:
        z = torch.stack([y.amax(-1), y.mean(-1)], dim=1)     # NCHW, C = 2
        a = getattr(self, name + "_bn")(getattr(self, name)(z))
        return y * torch.sigmoid(a.permute(0, 2, 3, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self._gate(x.permute(0, 3, 2, 1), "cw").permute(0, 3, 2, 1)
        b2 = self._gate(x.permute(0, 1, 3, 2), "hc").permute(0, 1, 3, 2)
        b3 = self._gate(x, "hw")
        return (b1 + b2 + b3) / 3.0


class SKAttention(nn.Module):
    """Selective kernel: conv + BN + ReLU branches of each kernel size,
    fused by GAP -> reduce -> a softmax over per-branch Dense logits."""

    def __init__(self, channels: int, kernels: tuple = (1, 3, 5),
                 reduction: int = 16, L: int = 32):
        super().__init__()
        self.kernels = tuple(kernels)
        d = max(L, channels // reduction)
        for k in self.kernels:
            setattr(self, f"conv{k}", SameConv2d(channels, channels, k))
            setattr(self, f"bn{k}", bare_batch_norm(channels))
        self.fc_reduce = nn.Linear(channels, d)
        for k in self.kernels:
            setattr(self, f"fc{k}", nn.Linear(d, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2)
        feats = [F.relu(getattr(self, f"bn{k}")(getattr(self, f"conv{k}")(
            xc))).permute(0, 2, 3, 1) for k in self.kernels]
        s = self.fc_reduce(sum(feats).mean((1, 2)))
        logits = [getattr(self, f"fc{k}")(s) for k in self.kernels]
        w = torch.softmax(torch.stack(logits, 1), dim=1)     # [B, n, C]
        return sum(f * w[:, i][:, None, None, :] for i, f in enumerate(feats))


class ExternalAttention(nn.Module):
    """Two shared memory units in place of K / V: softmax(x @ Mk) over the
    tokens, normalised over the memory, then @ Mv."""

    def __init__(self, channels: int, S: int = 64):
        super().__init__()
        self.mk = nn.Linear(channels, S, bias=False)
        self.mv = nn.Linear(S, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        attn = self.mk(x.reshape(b, h * w, c)).softmax(1)    # over tokens
        attn = attn / (attn.sum(2, keepdim=True) + 1e-9)
        return self.mv(attn).reshape(b, h, w, c)


class PolarizedSelfAttention(nn.Module):
    """Parallel polarized self-attention: a channel branch (values times a
    softmaxed spatial query -> Dense -> LN -> sigmoid) plus a spatial
    branch (a softmaxed pooled query times the values -> sigmoid map)."""

    def __init__(self, channels: int):
        super().__init__()
        half = max(channels // 2, 1)
        self.ch_wv = nn.Conv2d(channels, half, 1)
        self.ch_wq = nn.Conv2d(channels, 1, 1)
        self.ch_wz = nn.Linear(half, channels)
        self.ln = LayerNorm(channels)
        self.sp_wv = nn.Conv2d(channels, half, 1)
        self.sp_wq = nn.Conv2d(channels, half, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        xc = x.permute(0, 3, 1, 2)
        wv = self.ch_wv(xc).permute(0, 2, 3, 1).reshape(b, h * w, -1)
        wq = self.ch_wq(xc).permute(0, 2, 3, 1).reshape(b, h * w, 1)
        wz = torch.einsum("bnk,bno->bko", wv, wq.softmax(1))[..., 0]
        cw = torch.sigmoid(self.ln(self.ch_wz(wz)))[:, None, None, :]
        sv = self.sp_wv(xc).permute(0, 2, 3, 1).reshape(b, h * w, -1)
        sq = self.sp_wq(xc).mean((2, 3)).softmax(-1)        # [B, half]
        sw = torch.einsum("bk,bnk->bn", sq, sv).reshape(b, h, w, 1)
        return cw * x + torch.sigmoid(sw) * x


class SGE(nn.Module):
    """Spatial group enhance: each position's similarity to its group's
    mean, standardised over space (Bessel-corrected std), scaled and
    shifted by the free per-group `weight` / `bias` [1,1,1,g], a sigmoid
    gate."""

    def __init__(self, channels: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(1, 1, 1, groups))
        self.bias = nn.Parameter(torch.zeros(1, 1, 1, groups))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g = self.groups
        xg = x.reshape(b, h, w, g, c // g)
        t = (xg * xg.mean((1, 2), keepdim=True)).sum(-1)    # [B, H, W, g]
        mu = t.mean((1, 2), keepdim=True)
        var = t.var((1, 2), correction=0, keepdim=True)
        n = h * w
        std = torch.sqrt(var * n / max(n - 1, 1)) + 1e-5
        t = (t - mu) / std * self.weight + self.bias
        return (xg * torch.sigmoid(t)[..., None]).reshape(b, h, w, c)


class CoTAttention(nn.Module):
    """Contextual transformer: a static 3x3 group-conv key context and a
    dynamic reweighting of the values from a softmaxed attention
    embedding (its k·k axis averaged, the softmax over positions)."""

    def __init__(self, channels: int, kernel_size: int = 3, factor: int = 4):
        super().__init__()
        ks = self.kernel_size = kernel_size
        mid = 2 * channels // factor
        self.key = SameConv2d(channels, channels, ks, groups=4, bias=False)
        self.key_bn = bare_batch_norm(channels)
        self.value = nn.Conv2d(channels, channels, 1, bias=False)
        self.value_bn = bare_batch_norm(channels)
        self.att1 = nn.Conv2d(2 * channels, mid, 1, bias=False)
        self.att_bn = bare_batch_norm(mid)
        self.att2 = nn.Conv2d(mid, ks * ks * channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ks = self.kernel_size
        xc = x.permute(0, 3, 1, 2)
        k1 = F.relu(self.key_bn(self.key(xc)))
        v = self.value_bn(self.value(xc))
        a = F.relu(self.att_bn(self.att1(torch.cat([k1, xc], dim=1))))
        a = self.att2(a).permute(0, 2, 3, 1)
        att = a.reshape(b, h, w, ks * ks, c).mean(3).reshape(b, h * w, c)
        att = att.softmax(1).reshape(b, h, w, c)
        return (k1.permute(0, 2, 3, 1) + att * v.permute(0, 2, 3, 1))


class ParNetAttention(nn.Module):
    """ParNet block: silu(BN(1x1) + BN(3x3) + an SSE gate times x)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 1)
        self.bn1 = bare_batch_norm(channels)
        self.conv3 = SameConv2d(channels, channels, 3)
        self.bn3 = bare_batch_norm(channels)
        self.sse = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2)
        x1 = self.bn1(self.conv1(xc))
        x2 = self.bn3(self.conv3(xc))
        gate = torch.sigmoid(self.sse(xc.mean((2, 3), keepdim=True)))
        return F.silu(x1 + x2 + gate * xc).permute(0, 2, 3, 1)


def _shift(t: torch.Tensor, axis: int, d: int) -> torch.Tensor:
    """Shift by one along `axis` (d > 0: towards higher indices), the edge
    row keeping its value."""
    n = t.shape[axis]
    if d > 0:
        return torch.cat([t.narrow(axis, 0, 1), t.narrow(axis, 0, n - 1)],
                         axis)
    return torch.cat([t.narrow(axis, 1, n - 1), t.narrow(axis, n - 1, 1)],
                     axis)


def _spatial_shift(x: torch.Tensor, order: int) -> torch.Tensor:
    """S2-MLP's quarter-channel shifts, the edges held."""
    q = x.shape[-1] // 4
    parts = [x[..., :q], x[..., q:2 * q], x[..., 2 * q:3 * q], x[..., 3 * q:]]
    axes = (2, 2, 1, 1) if order == 1 else (1, 1, 2, 2)
    return torch.cat([_shift(p, a, d) for p, a, d in
                      zip(parts, axes, (1, -1, 1, -1))], dim=-1)


class S2Attention(nn.Module):
    """Spatial-shift MLP attention: expand 3x, two shifted branches and an
    unshifted one fused by split attention, project back."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.mlp1 = nn.Linear(c, 3 * c)
        self.sa_mlp1 = nn.Linear(c, c, bias=False)
        self.sa_mlp2 = nn.Linear(c, 3 * c, bias=False)
        self.mlp3 = nn.Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.mlp1(x)
        stacked = torch.stack([_spatial_shift(y[..., :c], 1),
                               _spatial_shift(y[..., c:2 * c], 2),
                               y[..., 2 * c:]], dim=1)      # [B, 3, H, W, C]
        a = stacked.sum((1, 2, 3))                          # [B, C]
        ah = self.sa_mlp2(F.gelu(self.sa_mlp1(a), approximate="tanh"))
        bar = ah.reshape(b, 3, c).softmax(1)
        return self.mlp3((stacked * bar[:, :, None, None, :]).sum(1))
