"""Heavy attention plug-ins: Halo, Outlook, MobileViT, ACmix, deformable
(DAT), port of `pl_yolo_tpu/layers/attention_extra.py`. NHWC in and out
(see `layers.attention`); windows come from `F.unfold`, whose output is
channel-major (C·k·k, the window offset fastest), as the JAX package's
`conv_general_dilated_patches` is."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.augment import bilinear_sample
from .attention_common import conv_nhwc
from .blocks import LayerNorm, SameConv2d


def _extract_patches(x: torch.Tensor, k: int, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """NHWC sliding windows: [B,H,W,C] -> [B, Ho, Wo, k*k, C], zero
    padding."""
    b, h, w, c = x.shape
    out = F.unfold(x.permute(0, 3, 1, 2), k, padding=padding, stride=stride)
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    return out.reshape(b, c, k * k, ho, wo).permute(0, 3, 4, 2, 1)


class DenseGeneral(nn.Module):
    """flax `nn.DenseGeneral` from the trailing `in_features` axes to
    `out_features` axes (the attention layers' of
    `nn.MultiHeadDotProductAttention`). `weight` is the flax kernel
    [*in, *out] with its axes reversed, as the bridge maps a 3-D kernel."""

    WEIGHT_IS_KERNEL = True

    def __init__(self, in_features: Sequence[int],
                 out_features: Sequence[int], bias: bool = True):
        super().__init__()
        self.n_in = len(in_features)
        shape = tuple(in_features) + tuple(out_features)
        fan_in = math.prod(in_features)
        self.weight = nn.Parameter(
            torch.randn(shape[::-1]) * fan_in ** -0.5)
        self.bias = (nn.Parameter(torch.zeros(tuple(out_features)))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.weight.permute(*range(self.weight.ndim - 1, -1, -1))
        y = torch.tensordot(x, kernel, dims=self.n_in)
        return y if self.bias is None else y + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(num_heads)` as self-attention
    over the second-to-last axis: `query`, `key`, `value` [dim -> heads,
    hd] and `out` [heads, hd -> dim], biased, the query scaled by
    1/sqrt(hd), a softmax over the keys."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        hd = dim // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral((dim,), (num_heads, hd)))
        self.out = DenseGeneral((num_heads, hd), (dim,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)
        q = q / math.sqrt(q.shape[-1])
        att = torch.einsum("...qhd,...khd->...hqk", q, k).softmax(-1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", att, v))


class HaloAttention(nn.Module):
    """Blocked local self-attention with halo keys: queries from
    non-overlapping block x block windows, keys and values from the
    (block + 2·halo)² haloed windows, a static relative-position bias
    table (`rel_bias` [heads, span, span]), keys in the zero padding
    masked."""

    def __init__(self, channels: int, block: int = 4, halo: int = 1,
                 heads: int = 4, dim_head: int = 16):
        super().__init__()
        self.block, self.halo, self.heads = block, halo, heads
        self.dim_head = dim_head
        inner = heads * dim_head
        span = 2 * (block + 2 * halo) - 1
        self.to_q = nn.Linear(channels, inner, bias=False)
        self.to_k = nn.Linear(channels, inner, bias=False)
        self.to_v = nn.Linear(channels, inner, bias=False)
        self.rel_bias = nn.Parameter(torch.randn(heads, span, span) * 0.02)
        self.to_out = nn.Linear(inner, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        blk, halo, heads = self.block, self.halo, self.heads
        if h % blk or w % blk:
            raise ValueError("H,W must divide block")
        inner = heads * self.dim_head
        bh = blk + 2 * halo
        nh, nw = h // blk, w // blk
        nq, nk = blk * blk, bh * bh

        q_in = x.reshape(b, nh, blk, nw, blk, c).permute(0, 1, 3, 2, 4, 5)
        q_in = q_in.reshape(b, nh * nw, nq, c)
        kv_in = _extract_patches(x, bh, stride=blk, padding=halo)
        kv_in = kv_in.reshape(b, nh * nw, nk, c)

        def split(t, n):
            return t.reshape(b, nh * nw, n, heads, self.dim_head
                             ).permute(0, 1, 3, 2, 4)

        q = split(self.to_q(q_in), nq)
        k = split(self.to_k(kv_in), nk)
        v = split(self.to_v(kv_in), nk)
        sim = torch.einsum("bwhid,bwhjd->bwhij", q, k) * self.dim_head ** -0.5

        qy, qx = np.meshgrid(np.arange(blk) + halo, np.arange(blk) + halo,
                             indexing="ij")
        ky, kx = np.meshgrid(np.arange(bh), np.arange(bh), indexing="ij")
        dy = (qy.reshape(-1, 1) - ky.reshape(1, -1)) + bh - 1   # [nq, nk]
        dx = (qx.reshape(-1, 1) - kx.reshape(1, -1)) + bh - 1
        dy, dx = (torch.as_tensor(d, device=x.device) for d in (dy, dx))
        sim = sim + self.rel_bias[:, dy, dx][None, None]

        ones = torch.ones((1, h, w, 1), dtype=sim.dtype, device=x.device)
        kmask = _extract_patches(ones, bh, stride=blk, padding=halo)
        kmask = kmask.reshape(1, nh * nw, 1, 1, nk) > 0
        sim = torch.where(kmask, sim, torch.finfo(sim.dtype).min)

        out = torch.einsum("bwhij,bwhjd->bwhid", sim.softmax(-1), v)
        out = out.permute(0, 1, 3, 2, 4).reshape(b, nh * nw, nq, inner)
        out = self.to_out(out)
        out = out.reshape(b, nh, nw, blk, blk, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, c)


class OutlookAttention(nn.Module):
    """Outlook attention, stride 1: each position predicts a k² x k²
    attention over its window from its own features; the outputs are
    overlap-added (the fold) as k² shifted sums, in the JAX order."""

    def __init__(self, channels: int, kernel: int = 3, heads: int = 2):
        super().__init__()
        self.kernel, self.heads = kernel, heads
        kk = kernel * kernel
        self.v = nn.Linear(channels, channels, bias=False)
        self.attn = nn.Linear(channels, kk * kk * heads)
        self.proj = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        k, heads = self.kernel, self.heads
        hd = c // heads
        kk = k * k
        pad = k // 2
        v_pat = _extract_patches(self.v(x), k, padding=pad)  # [B,H,W,kk,C]
        v_pat = v_pat.reshape(b, h, w, kk, heads, hd)
        attn = self.attn(x).reshape(b, h, w, heads, kk, kk) * hd ** -0.5
        out = torch.einsum("bhwgij,bhwjgd->bhwigd", attn.softmax(-1), v_pat)
        out = out.reshape(b, h, w, kk, c)
        # fold: out[i,j,t] goes to pixel (i + t_y - pad, j + t_x - pad)
        folded = x.new_zeros((b, h + 2 * pad, w + 2 * pad, c))
        for t in range(kk):
            ty, tx = t // k, t % k
            folded = folded + F.pad(out[:, :, :, t], (
                0, 0, tx, 2 * pad - tx, ty, 2 * pad - ty))
        return self.proj(folded[:, pad:pad + h, pad:pad + w])


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(x)))


class MobileViTAttention(nn.Module):
    """MobileViT block: local 3x3 + 1x1 convs, a transformer over
    cross-patch tokens (token t = pixel offset t across the patch grid),
    1x1 back, concat with the input, 3x3 fuse."""

    def __init__(self, channels: int, dim: int = 64, patch: int = 2,
                 depth: int = 2, heads: int = 4, mlp_ratio: float = 2.0):
        super().__init__()
        self.dim, self.patch, self.depth = dim, patch, depth
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv2 = nn.Conv2d(channels, dim, 1)
        for i in range(depth):
            setattr(self, f"ln_a{i}", LayerNorm(dim))
            setattr(self, f"attn{i}", MultiHeadDotProductAttention(dim,
                                                                   heads))
            setattr(self, f"ln_m{i}", LayerNorm(dim))
            setattr(self, f"mlp{i}", MLP(dim, int(dim * mlp_ratio)))
        self.conv3 = nn.Conv2d(dim, channels, 1)
        self.conv4 = nn.Conv2d(2 * channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p, dim = self.patch, self.dim
        if h % p or w % p:
            raise ValueError("H,W must divide patch")
        y = self.conv2(self.conv1(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        nh, nw = h // p, w // p
        y = y.reshape(b, nh, p, nw, p, dim).permute(0, 2, 4, 1, 3, 5)
        y = y.reshape(b, p * p, nh * nw, dim)
        for i in range(self.depth):
            y = y + getattr(self, f"attn{i}")(getattr(self, f"ln_a{i}")(y))
            y = y + getattr(self, f"mlp{i}")(getattr(self, f"ln_m{i}")(y))
        y = y.reshape(b, p, p, nh, nw, dim).permute(0, 3, 1, 4, 2, 5)
        y = conv_nhwc(self.conv3, y.reshape(b, h, w, dim))
        return conv_nhwc(self.conv4, torch.cat([x, y], dim=-1))


class ACmix(nn.Module):
    """ACmix: shared 1x1 q/k/v projections feed both a local-window
    self-attention (kernel_att, with a learned positional map) and a
    shift-conv path (k² maps, each shifted by its offset, mixed back to C),
    summed with learned rates (`rate1`, `rate2` [1], from 0.5). The shift
    path reads the first C/heads of the 3·heads mixed maps, so it needs
    C/heads <= 3·heads (the JAX package's slice fails otherwise)."""

    def __init__(self, channels: int, kernel_att: int = 7,
                 kernel_conv: int = 3, heads: int = 4):
        super().__init__()
        hd = channels // heads
        if hd > 3 * heads:
            raise ValueError(f"ACmix: channels/heads = {hd} exceeds 3·heads "
                             f"= {3 * heads}")
        self.kernel_att, self.kernel_conv, self.heads = (kernel_att,
                                                         kernel_conv, heads)
        self.conv1 = nn.Conv2d(channels, channels, 1)
        self.conv2 = nn.Conv2d(channels, channels, 1)
        self.conv3 = nn.Conv2d(channels, channels, 1)
        self.conv_p = nn.Conv2d(2, hd, 1)
        self.fc = nn.Linear(hd, kernel_conv ** 2, bias=False)
        self.dep_mix = nn.Linear(hd, channels)
        self.rate1 = nn.Parameter(torch.full((1,), 0.5))
        self.rate2 = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = self.heads
        hd = c // heads
        ka = self.kernel_att
        kc = self.kernel_conv
        kk = kc * kc
        pad = ka // 2
        xc = x.permute(0, 3, 1, 2)
        q, k, v = (conv(xc).permute(0, 2, 3, 1)
                   for conv in (self.conv1, self.conv2, self.conv3))

        # learned positional encoding from normalised coordinates
        gx, gy = torch.meshgrid(
            torch.linspace(-1, 1, w, device=x.device),
            torch.linspace(-1, 1, h, device=x.device), indexing="xy")
        loc = torch.stack([gx, gy], dim=-1)[None].to(x.dtype)
        pe = conv_nhwc(self.conv_p, loc)                     # [1,H,W,hd]

        def win(t):  # reflection-padded local windows
            tp = F.pad(t.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")
            return _extract_patches(tp.permute(0, 2, 3, 1), ka)

        k_win = win(k).reshape(b, h, w, ka * ka, heads, hd)
        v_win = win(v).reshape(b, h, w, ka * ka, heads, hd)
        pe_win = win(pe).reshape(1, h, w, ka * ka, 1, hd)
        qh = q.reshape(b, h, w, heads, hd) * hd ** -0.5
        att = torch.einsum("bhwgd,bhwjgd->bhwgj", qh,
                           k_win + pe[:, :, :, None, None] - pe_win)
        out_att = torch.einsum("bhwgj,bhwjgd->bhwgd", att.softmax(-1), v_win)
        out_att = out_att.reshape(b, h, w, c)

        # conv path: a per-position mix of the q/k/v head maps -> k² maps
        f_all = torch.cat([t.reshape(b, h, w, heads, hd) for t in (q, k, v)],
                          dim=3)                        # [B,H,W,3·heads,hd]
        f_mix = self.fc(f_all).permute(0, 1, 2, 4, 3)   # [B,H,W,kk,3·heads]
        cp = kc // 2
        fp = F.pad(f_mix, (0, 0, 0, 0, cp, cp, cp, cp))
        acc = x.new_zeros((b, h, w, hd))
        for t in range(kk):
            dy, dx = t // kc - cp, t % kc - cp
            acc = acc + fp[:, cp + dy:cp + dy + h, cp + dx:cp + dx + w, t,
                           :hd]
        out_conv = self.dep_mix(acc)
        return self.rate1 * out_att + self.rate2 * out_conv


class DAttention(nn.Module):
    """Deformable attention (DAT): a grouped depthwise offset network
    ('SAME' stride `downsample`, which pads an even map (1, 2) for the
    5x5 kernel) predicts sample points; k / v are sampled bilinearly there
    (align_corners semantics, zero outside) and attended by every
    query."""

    def __init__(self, channels: int, heads: int = 4, groups: int = 2,
                 offset_ks: int = 5, offset_range: float = 2.0,
                 downsample: int = 2):
        super().__init__()
        self.heads, self.groups = heads, groups
        self.offset_range, self.downsample = offset_range, downsample
        gc = channels // groups
        self.proj_q = nn.Conv2d(channels, channels, 1)
        self.off_dw = SameConv2d(gc, gc, offset_ks, downsample, groups=gc)
        self.off_ln = LayerNorm(gc)
        self.off_pw = nn.Conv2d(gc, 2, 1, bias=False)
        self.proj_k = nn.Linear(channels, channels)
        self.proj_v = nn.Linear(channels, channels)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g = self.groups
        gc = c // g
        hd = c // self.heads
        ds = self.downsample
        hk, wk = max(h // ds, 1), max(w // ds, 1)
        dev = x.device

        q = conv_nhwc(self.proj_q, x)
        q_off = q.reshape(b, h, w, g, gc).permute(0, 3, 1, 2, 4)
        o = conv_nhwc(self.off_dw, q_off.reshape(b * g, h, w, gc))
        o = F.gelu(self.off_ln(o), approximate="tanh")
        off = conv_nhwc(self.off_pw, o)
        off = torch.tanh(off) * (self.offset_range / torch.tensor(
            [hk, wk], dtype=torch.int32, device=dev))

        ry = (torch.arange(hk, device=dev) + 0.5) / hk * 2 - 1
        rx = (torch.arange(wk, device=dev) + 0.5) / wk * 2 - 1
        ref = torch.stack(torch.meshgrid(ry, rx, indexing="ij"), -1)
        pos = ref[None] + off                                # [B*g,hk,wk,2]

        xg = x.reshape(b, h, w, g, gc).permute(0, 3, 1, 2, 4)
        xg = xg.reshape(b * g, h, w, gc)
        py = (pos[..., 0] + 1) * 0.5 * (h - 1)
        px = (pos[..., 1] + 1) * 0.5 * (w - 1)
        sampled = bilinear_sample(xg, px, py, fill=0.0)      # [B*g,hk,wk,gc]
        sampled = sampled.reshape(b, g, hk * wk, gc).transpose(1, 2)
        sampled = sampled.reshape(b, hk * wk, c)

        kt = self.proj_k(sampled).reshape(b, -1, self.heads, hd)
        vt = self.proj_v(sampled).reshape(b, -1, self.heads, hd)
        qt = q.reshape(b, h * w, self.heads, hd) * hd ** -0.5
        att = torch.einsum("bmhd,bnhd->bhmn", qt, kt).softmax(-1)
        out = torch.einsum("bhmn,bnhd->bmhd", att, vt).reshape(b, h, w, c)
        return conv_nhwc(self.proj_out, out)
