"""Token-style attention plug-ins: Self, SimplifiedSelf, UFO, MUSE, AFT,
MobileViTv2, EMSA, DANet, A2 (double attention), port of
`pl_yolo_tpu/layers/attention_seq.py`. NHWC in and out (see
`layers.attention`), the H·W pixels the tokens."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .attention_common import attend, conv_nhwc, pick_heads
from .blocks import LayerNorm, SameConv2d


class _QKV(nn.Module):
    """fc_q, fc_k, fc_v and fc_o over `channels`, split into heads."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.h = pick_heads(channels, heads)
        self.dk = channels // self.h
        for name in ("fc_q", "fc_k", "fc_v", "fc_o"):
            setattr(self, name, nn.Linear(channels, channels))

    def qkv(self, t: torch.Tensor):
        b = t.shape[0]
        return [getattr(self, n)(t).reshape(b, -1, self.h, self.dk)
                for n in ("fc_q", "fc_k", "fc_v")]


class ScaledDotProductAttention(_QKV):
    """Multi-head self-attention over the H·W tokens."""

    def __init__(self, channels: int, heads: int = 8):
        super().__init__(channels, heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        q, k, v = self.qkv(x.reshape(b, hh * ww, c))
        out = self.fc_o(attend(q, k, v, self.dk).reshape(b, -1, c))
        return out.reshape(b, hh, ww, c)


class SimplifiedSelfAttention(nn.Module):
    """Projection-free multi-head attention (q = k = v = x), the output
    projection learned."""

    def __init__(self, channels: int, heads: int = 8):
        super().__init__()
        self.h = pick_heads(channels, heads)
        self.fc_o = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        dk = c // self.h
        t = x.reshape(b, hh * ww, self.h, dk)
        out = self.fc_o(attend(t, t, t, dk).reshape(b, -1, c))
        return out.reshape(b, hh, ww, c)


class UFOAttention(_QKV):
    """Softmax-free linear attention: KV contracted first, then XNorm (L2
    row normalisation times the free per-head `gamma` [1,h,1,1]) on KV and
    Q."""

    def __init__(self, channels: int, heads: int = 8):
        super().__init__(channels, heads)
        self.gamma = nn.Parameter(torch.randn(1, self.h, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        q, k, v = self.qkv(x.reshape(b, hh * ww, c))

        def xnorm(u):
            n = torch.sqrt((u * u).sum(-1, keepdim=True) + 1e-9)
            return u * self.gamma / n

        kv = torch.einsum("bnhd,bnhe->bhde", k, v)          # [B,h,dk,dk]
        out = torch.einsum("bhnd,bhde->bnhe", xnorm(q.transpose(1, 2)),
                           xnorm(kv))
        return self.fc_o(out.reshape(b, -1, c)).reshape(b, hh, ww, c)


class MUSEAttention(_QKV):
    """Self-attention beside depthwise-separable 1-D convs over the token
    axis (kernels 1, 3, 5) of the values, mixed by the softmax of the free
    3-vector `dy_paras`."""

    def __init__(self, channels: int, heads: int = 8):
        super().__init__(channels, heads)
        c = channels
        for ksz in (1, 3, 5):
            if ksz > 1:
                setattr(self, f"dw{ksz}", nn.Conv1d(c, c, ksz,
                                                    padding=ksz // 2,
                                                    groups=c))
            setattr(self, f"pw{ksz}", nn.Conv1d(c, c, 1))
        self.dy_paras = nn.Parameter(torch.ones(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        q, k, v = self.qkv(x.reshape(b, hh * ww, c))
        out = self.fc_o(attend(q, k, v, self.dk).reshape(b, -1, c))
        v2 = v.reshape(b, -1, c).transpose(1, 2)            # [B, C, N]
        branches = []
        for ksz in (1, 3, 5):
            u = v2 if ksz == 1 else getattr(self, f"dw{ksz}")(v2)
            branches.append(getattr(self, f"pw{ksz}")(u).transpose(1, 2))
        w = self.dy_paras.softmax(0)
        out = out + sum(w[i] * branches[i] for i in range(3))
        return out.reshape(b, hh, ww, c)


class AFTFull(nn.Module):
    """Attention Free Transformer, full: sigmoid(Q) · Σ_j softmax_j(K_j +
    w_ij) V_j with the free pairwise bias `position_biases` [N, N] (N =
    H·W of `size`); the logits are [B, N, N, C]."""

    def __init__(self, channels: int, size: Sequence[int]):
        super().__init__()
        n = size[0] * size[1]
        self.fc_q = nn.Linear(channels, channels)
        self.fc_k = nn.Linear(channels, channels)
        self.fc_v = nn.Linear(channels, channels)
        self.position_biases = nn.Parameter(torch.ones(n, n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        t = x.reshape(b, hh * ww, c)
        q, k, v = self.fc_q(t), self.fc_k(t), self.fc_v(t)
        logits = k[:, None, :, :] + self.position_biases[None, :, :, None]
        out = torch.einsum("bijc,bjc->bic", logits.softmax(2), v)
        return (torch.sigmoid(q) * out).reshape(b, hh, ww, c)


class MobileViTv2Attention(nn.Module):
    """Separable self-attention: one context score a token, a softmax over
    the tokens, the context vector gating the values."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc_i = nn.Linear(channels, 1)
        self.fc_k = nn.Linear(channels, channels)
        self.fc_v = nn.Linear(channels, channels)
        self.fc_o = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        t = x.reshape(b, hh * ww, c)
        weight_i = self.fc_i(t).softmax(1)                  # [B,N,1]
        context = (weight_i * self.fc_k(t)).sum(1, keepdim=True)
        out = self.fc_o(self.fc_v(t) * context)
        return out.reshape(b, hh, ww, c)


class EMSA(_QKV):
    """Efficient multi-head self-attention (ResT): K / V from a strided
    depthwise conv + LayerNorm reduction; with `apply_transform` and more
    than one head the attention map is mixed across heads (`head_mix`),
    softmaxed and instance-normalised."""

    def __init__(self, channels: int, heads: int = 8, ratio: int = 2,
                 apply_transform: bool = True):
        super().__init__(channels, heads)
        self.ratio = ratio
        self.transform = apply_transform and self.h > 1
        if ratio > 1:
            self.sr_conv = nn.Conv2d(channels, channels, ratio + 1, ratio,
                                     ratio // 2, groups=channels)
            self.sr_ln = LayerNorm(channels)
        if self.transform:
            self.head_mix = nn.Linear(self.h, self.h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h, dk = self.h, self.dk
        t = x.reshape(b, hh * ww, c)
        q = self.fc_q(t).reshape(b, -1, h, dk)
        red = t
        if self.ratio > 1:
            red = self.sr_ln(conv_nhwc(self.sr_conv, x).reshape(b, -1, c))
        k = self.fc_k(red).reshape(b, -1, h, dk)
        v = self.fc_v(red).reshape(b, -1, h, dk)
        att = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(dk)
        if self.transform:
            att = self.head_mix(att.movedim(1, -1)).movedim(-1, 1)
            att = att.softmax(-1)
            mu = att.mean((2, 3), keepdim=True)
            var = att.var((2, 3), correction=0, keepdim=True)
            att = (att - mu) * torch.rsqrt(var + 1e-5)
        else:
            att = att.softmax(-1)
        out = torch.einsum("bhnm,bmhd->bnhd", att, v).reshape(b, -1, c)
        return self.fc_o(out).reshape(b, hh, ww, c)


class DAModule(nn.Module):
    """Dual attention (DANet): a position branch (3x3 conv, then
    single-head self-attention over the pixels) plus a channel branch (3x3
    conv, then projection-free attention over the channels as tokens of
    dim H·W, whose `ch_o` is [N, N] for N = H·W of `size`)."""

    def __init__(self, channels: int, size: Sequence[int],
                 kernel_size: int = 3):
        super().__init__()
        c, n = channels, size[0] * size[1]
        self.pos_cnn = SameConv2d(c, c, kernel_size)
        for name in ("pos_q", "pos_k", "pos_v", "pos_o"):
            setattr(self, name, nn.Linear(c, c))
        self.ch_cnn = SameConv2d(c, c, kernel_size)
        self.ch_o = nn.Linear(n, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        n = hh * ww
        y = conv_nhwc(self.pos_cnn, x).reshape(b, n, c)
        q, k, v = self.pos_q(y), self.pos_k(y), self.pos_v(y)
        att = (torch.einsum("bnc,bmc->bnm", q, k) / math.sqrt(c)).softmax(-1)
        p_out = self.pos_o(torch.einsum("bnm,bmc->bnc", att, v))
        z = conv_nhwc(self.ch_cnn, x).reshape(b, n, c).transpose(1, 2)
        catt = (torch.einsum("bcn,bdn->bcd", z, z) / math.sqrt(n)).softmax(-1)
        c_out = self.ch_o(torch.einsum("bcd,bdn->bcn", catt, z))
        return (p_out + c_out.transpose(1, 2)).reshape(b, hh, ww, c)


class DoubleAttention(nn.Module):
    """A2-Nets double attention: global descriptors gathered with maps
    softmaxed over the pixels, redistributed with vectors softmaxed over
    c_n, optionally projected back (`conv_reconstruct`)."""

    def __init__(self, channels: int, reduction: int = 4,
                 reconstruct: bool = True):
        super().__init__()
        cm = cn = max(channels // reduction, 1)
        self.reconstruct = reconstruct
        self.convA = nn.Conv2d(channels, cm, 1)
        self.convB = nn.Conv2d(channels, cn, 1)
        self.convV = nn.Conv2d(channels, cn, 1)
        if reconstruct:
            self.conv_reconstruct = nn.Linear(cm, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        xc = x.permute(0, 3, 1, 2)

        def tokens(conv):
            return conv(xc).permute(0, 2, 3, 1).reshape(b, hh * ww, -1)
        a, bb, v = tokens(self.convA), tokens(self.convB), tokens(self.convV)
        g = torch.einsum("bnm,bnk->bmk", a, bb.softmax(1))
        z = torch.einsum("bmk,bnk->bnm", g, v.softmax(2))
        if self.reconstruct:
            z = self.conv_reconstruct(z)
        return z.reshape(b, hh, ww, c)

