"""Spatially-structured attention plug-ins: CrissCross, Axial, Crossformer,
MOA, GFNet, ViP, EPSA pyramid split, sequential polarized, CoAtNet hybrid,
CA_Block, FCA multi-spectral, ResidualAttention, port of
`pl_yolo_tpu/layers/attention_spatial.py`. NHWC in and out (see
`layers.attention`); ResidualAttention returns [B, num_classes]. The
static tables (relative positions, DCT filters, pooling matrices) are
built with numpy, as in the JAX package."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention_common import (attend, bare_batch_norm, conv_nhwc,
                               pick_heads)
from .blocks import LayerNorm, SameConv2d


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax nn.gelu


class CrissCrossAttention(nn.Module):
    """Criss-cross attention: each pixel attends to its row and column; the
    column energies mask their own diagonal with -1e9, one softmax over
    H + W, and the free scalar `gamma` (from 0) gates the residual."""

    def __init__(self, channels: int):
        super().__init__()
        c8 = max(channels // 8, 1)
        self.query_conv = nn.Conv2d(channels, c8, 1)
        self.key_conv = nn.Conv2d(channels, c8, 1)
        self.value_conv = nn.Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh = x.shape[1]
        q, k, v = (conv_nhwc(m, x) for m in (self.query_conv, self.key_conv,
                                             self.value_conv))
        e_h = torch.einsum("bhwc,bkwc->bhwk", q, k)          # [B,H,W,H]
        e_h = e_h - 1e9 * torch.eye(hh, dtype=x.dtype,
                                    device=x.device)[:, None, :]
        e_w = torch.einsum("bhwc,bhkc->bhwk", q, k)          # [B,H,W,W]
        att = torch.cat([e_h, e_w], dim=3).softmax(3)
        out_h = torch.einsum("bhwk,bkwc->bhwc", att[..., :hh], v)
        out_w = torch.einsum("bhwk,bhkc->bhwc", att[..., hh:], v)
        return self.gamma * (out_h + out_w) + x


class AxialAttention(nn.Module):
    """Multi-head self-attention along H and along W (`h_*`, `w_*`
    projections), summed."""

    def __init__(self, channels: int, heads: int = 8):
        super().__init__()
        c = channels
        self.h = pick_heads(c, heads)
        for axis in ("h", "w"):
            setattr(self, f"{axis}_q", nn.Linear(c, c, bias=False))
            setattr(self, f"{axis}_kv", nn.Linear(c, 2 * c, bias=False))
            setattr(self, f"{axis}_out", nn.Linear(c, c))

    def _along(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        n, c = t.shape[1], t.shape[2]
        dk = c // self.h
        q = getattr(self, f"{axis}_q")(t)
        k, v = getattr(self, f"{axis}_kv")(t).chunk(2, dim=-1)
        q, k, v = (u.reshape(-1, n, self.h, dk) for u in (q, k, v))
        return getattr(self, f"{axis}_out")(attend(q, k, v, dk)
                                            .reshape(-1, n, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        along_h = self._along(x.transpose(1, 2).reshape(b * ww, hh, c), "h")
        along_h = along_h.reshape(b, ww, hh, c).transpose(1, 2)
        along_w = self._along(x.reshape(b * hh, ww, c), "w")
        return along_h + along_w.reshape(b, hh, ww, c)


class CrossformerAttention(nn.Module):
    """Crossformer group attention: windows of `group_size`² tokens attend
    locally, with a dynamic position bias (an MLP over the (2G-1)² offset
    grid); a map not divisible by G is zero-padded and cropped back."""

    def __init__(self, channels: int, group_size: int = 8, heads: int = 8):
        super().__init__()
        c = channels
        self.g = group_size
        self.h = pick_heads(c, heads)
        pd = max(c // 4 // 4, 4)
        self.qkv = nn.Linear(c, 3 * c)
        self.pos_proj = nn.Linear(2, pd)
        for i in (1, 2, 3):
            setattr(self, f"pos_ln{i}", LayerNorm(pd))
        self.pos1 = nn.Linear(pd, pd)
        self.pos2 = nn.Linear(pd, pd)
        self.pos3 = nn.Linear(pd, self.h)
        self.proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        g, h = self.g, self.h
        dk = c // h
        ph, pw = (-hh) % g, (-ww) % g
        xp = F.pad(x, (0, 0, 0, pw, 0, ph))
        gh, gw = (hh + ph) // g, (ww + pw) // g
        n = g * g
        win = xp.reshape(b, gh, g, gw, g, c).permute(0, 1, 3, 2, 4, 5)
        win = win.reshape(b * gh * gw, n, c)
        qkv = self.qkv(win).reshape(-1, n, 3, h, dk)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        att = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(dk)

        off = np.stack(np.meshgrid(np.arange(1 - g, g), np.arange(1 - g, g),
                                   indexing="ij"), -1).reshape(-1, 2)
        pos = self.pos_proj(torch.as_tensor(off, dtype=torch.float32,
                                            device=x.device))
        pos = self.pos1(F.relu(self.pos_ln1(pos)))
        pos = self.pos2(F.relu(self.pos_ln2(pos)))
        pos = self.pos3(F.relu(self.pos_ln3(pos)))          # [(2G-1)², h]
        coords = np.stack(np.meshgrid(np.arange(g), np.arange(g),
                                      indexing="ij"), -1).reshape(-1, 2)
        rel = coords[:, None] - coords[None, :] + (g - 1)   # [n,n,2] >= 0
        rel_idx = torch.as_tensor(rel[..., 0] * (2 * g - 1) + rel[..., 1],
                                  device=x.device)
        bias = pos[rel_idx.reshape(-1)].reshape(n, n, h)
        att = (att + bias.permute(2, 0, 1)[None]).softmax(-1)
        out = torch.einsum("bhnm,bmhd->bnhd", att, v).reshape(-1, n, c)
        out = self.proj(out)
        out = out.reshape(b, gh, gw, g, g, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, gh * g, gw * g, c)[:, :hh, :ww]


class MOAGlobalAttention(nn.Module):
    """Multi-resolution overlapped attention: queries from non-overlapping
    `window`² patches, keys / values from overlapping (window + 2)²
    patches, a relative-position bias over the window grid (the free
    `relative_position_bias_table`, sized from `size`), each window's
    output broadcast over it and added to the map."""

    def __init__(self, channels: int, size: Sequence[int], window: int = 4,
                 heads: int = 8, reduction: int = 4):
        super().__init__()
        c, g = channels, window
        self.g = g
        self.h = pick_heads(c, heads)
        self.red = red = max(c // reduction, 1)
        gh, gw = -(-size[0] // g), -(-size[1] // g)
        self.pre_conv = nn.Conv2d(c, red, 1)
        self.q = nn.Linear(g * g * red, c)
        self.kv = nn.Linear((g + 2) ** 2 * red, 2 * c)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * gh - 1) * (2 * gw - 1), self.h))
        self.proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        g, h, red = self.g, self.h, self.red
        dk = c // h
        ph, pw = (-hh) % g, (-ww) % g
        xp = F.pad(x, (0, 0, 0, pw, 0, ph))
        gh, gw = (hh + ph) // g, (ww + pw) // g
        n = gh * gw
        y = conv_nhwc(self.pre_conv, xp)
        qpatch = y.reshape(b, gh, g, gw, g, red).permute(0, 1, 3, 2, 4, 5)
        q = self.q(qpatch.reshape(b, n, g * g * red)).reshape(b, n, h, dk)
        yp = F.pad(y, (0, 0, 1, 1, 1, 1))
        ksz = g + 2
        kpatch = torch.stack([yp[:, i::g, j::g][:, :gh, :gw]
                              for i in range(ksz) for j in range(ksz)],
                             dim=-2)            # [B, gh, gw, ksz², red]
        kv = self.kv(kpatch.reshape(b, n, ksz * ksz * red))
        kv = kv.reshape(b, n, 2, h, dk)
        k, v = kv[:, :, 0], kv[:, :, 1]
        att = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(dk)
        coords = np.stack(np.meshgrid(np.arange(gh), np.arange(gw),
                                      indexing="ij"), -1).reshape(-1, 2)
        rel = coords[:, None] - coords[None, :]
        rel[..., 0] += gh - 1
        rel[..., 1] += gw - 1
        rel_idx = torch.as_tensor(rel[..., 0] * (2 * gw - 1) + rel[..., 1],
                                  device=x.device)
        bias = self.relative_position_bias_table[rel_idx.reshape(-1)]
        att = (att + bias.reshape(n, n, h).permute(2, 0, 1)[None]).softmax(-1)
        out = torch.einsum("bhnm,bmhd->bnhd", att, v).reshape(b, n, c)
        out = self.proj(out).reshape(b, gh, 1, gw, 1, c)
        out = out.expand(b, gh, g, gw, g, c).reshape(b, gh * g, gw * g, c)
        return x + out[:, :hh, :ww]


class GFNetBlock(nn.Module):
    """Global-filter block: LayerNorm -> 2-D real FFT over the map (fp32,
    'ortho') -> the learned complex filter (`filter_re`, `filter_im` [H,
    W//2+1, C] of `size`) -> inverse FFT -> LayerNorm -> MLP, one
    residual."""

    def __init__(self, channels: int, size: Sequence[int],
                 mlp_ratio: int = 4):
        super().__init__()
        c = channels
        shape = (size[0], size[1] // 2 + 1, c)
        self.norm1 = LayerNorm(c)
        self.filter_re = nn.Parameter(torch.randn(shape) * 0.02)
        self.filter_im = nn.Parameter(torch.randn(shape) * 0.02)
        self.norm2 = LayerNorm(c)
        self.fc1 = nn.Linear(c, mlp_ratio * c)
        self.fc2 = nn.Linear(mlp_ratio * c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh, ww = x.shape[1], x.shape[2]
        y = self.norm1(x)
        f = torch.fft.rfft2(y.to(torch.float32), dim=(1, 2), norm="ortho")
        f = f * torch.complex(self.filter_re.to(torch.float32),
                              self.filter_im.to(torch.float32))
        y = torch.fft.irfft2(f, s=(hh, ww), dim=(1, 2),
                             norm="ortho").to(x.dtype)
        y = self.fc2(_gelu(self.fc1(self.norm2(y))))
        return x + y


class ViPAttention(nn.Module):
    """Vision Permutator's weighted permute-MLP: channel, H-segment and
    W-segment mixings (`mlp_h`, `mlp_w` sized from `size`), fused by
    softmaxed per-branch weights from a squeeze MLP."""

    def __init__(self, channels: int, size: Sequence[int], seg_dim: int = 8):
        super().__init__()
        c = channels
        seg = seg_dim
        while c % seg:
            seg //= 2
        self.seg = seg
        s = c // seg
        self.mlp_c = nn.Linear(c, c, bias=False)
        self.mlp_h = nn.Linear(size[0] * s, size[0] * s, bias=False)
        self.mlp_w = nn.Linear(size[1] * s, size[1] * s, bias=False)
        self.rw_fc1 = nn.Linear(c, max(c // 4, 1))
        self.rw_fc2 = nn.Linear(max(c // 4, 1), 3 * c)
        self.proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        seg = self.seg
        s = c // seg
        c_embed = self.mlp_c(x)
        t = x.reshape(b, hh, ww, seg, s).permute(0, 3, 2, 1, 4)
        t = self.mlp_h(t.reshape(b, seg, ww, hh * s))
        h_embed = t.reshape(b, seg, ww, hh, s).permute(
            0, 3, 2, 1, 4).reshape(b, hh, ww, c)
        t = x.reshape(b, hh, ww, seg, s).permute(0, 3, 1, 2, 4)
        t = self.mlp_w(t.reshape(b, seg, hh, ww * s))
        w_embed = t.reshape(b, seg, hh, ww, s).permute(
            0, 2, 3, 1, 4).reshape(b, hh, ww, c)
        wgt = (c_embed + h_embed + w_embed).mean((1, 2))
        wgt = self.rw_fc2(_gelu(self.rw_fc1(wgt)))
        wgt = wgt.reshape(b, c, 3).softmax(-1)[:, None, None]  # [B,1,1,C,3]
        out = (c_embed * wgt[..., 0] + w_embed * wgt[..., 1]
               + h_embed * wgt[..., 2])
        return self.proj(out)


class PyramidSplitAttention(nn.Module):
    """EPSANet pyramid split attention: S channel groups convolved at
    kernels 3, 5, 7, 9, each group's SE weights softmaxed across the
    groups."""

    def __init__(self, channels: int, S: int = 4, reduction: int = 4):
        super().__init__()
        s = S
        while channels % s:
            s //= 2
        self.s = s
        ci = channels // s
        for i in range(s):
            setattr(self, f"conv{i}", SameConv2d(ci, ci, 2 * (i + 1) + 1))
        red = max(ci // reduction, 1)
        self.se_fc1 = nn.Linear(ci, red, bias=False)
        self.se_fc2 = nn.Linear(red, ci, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        ci = c // self.s
        spc = torch.stack([conv_nhwc(getattr(self, f"conv{i}"),
                                     x[..., i * ci:(i + 1) * ci])
                           for i in range(self.s)], dim=3)  # [B,H,W,S,ci]
        se = self.se_fc2(F.relu(self.se_fc1(spc.mean((1, 2)))))
        se = torch.sigmoid(se).softmax(1)[:, None, None]
        return (spc * se).reshape(b, hh, ww, c)


class SequentialPolarizedSelfAttention(nn.Module):
    """Sequential polarized self-attention: the channel branch gates x,
    then the spatial branch runs on the gated map."""

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
        b, hh, ww, c = x.shape
        wv = conv_nhwc(self.ch_wv, x).reshape(b, hh * ww, -1)
        wq = conv_nhwc(self.ch_wq, x).reshape(b, hh * ww, 1).softmax(1)
        wz = torch.einsum("bnk,bno->bko", wv, wq)[..., 0]
        cw = torch.sigmoid(self.ln(self.ch_wz(wz)))[:, None, None, :]
        y = cw * x
        sv = conv_nhwc(self.sp_wv, y).reshape(b, hh * ww, -1)
        sq = conv_nhwc(self.sp_wq, y).mean((1, 2)).softmax(-1)
        sw = torch.einsum("bk,bnk->bn", sq, sv).reshape(b, hh, ww, 1)
        return torch.sigmoid(sw) * y


class CoAtNetBlock(nn.Module):
    """CoAtNet's composition at constant shape: an MBConv block (expand,
    depthwise, SE, project; BatchNorms that train) and then token
    self-attention, each residual."""

    def __init__(self, channels: int, expansion: int = 4, heads: int = 8):
        super().__init__()
        c = channels
        mid = c * expansion
        self.expand = nn.Conv2d(c, mid, 1, bias=False)
        self.bn1 = bare_batch_norm(mid)
        self.dw = SameConv2d(mid, mid, 3, groups=mid, bias=False)
        self.bn2 = bare_batch_norm(mid)
        self.se_fc1 = nn.Linear(mid, max(c // 4, 1))
        self.se_fc2 = nn.Linear(max(c // 4, 1), mid)
        self.project = nn.Conv2d(mid, c, 1, bias=False)
        self.bn3 = bare_batch_norm(c)
        self.h = pick_heads(c, heads)
        for name in ("att_q", "att_k", "att_v", "att_o"):
            setattr(self, name, nn.Linear(c, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        y = _gelu(self.bn1(self.expand(x.permute(0, 3, 1, 2))))
        y = _gelu(self.bn2(self.dw(y)))
        se = self.se_fc2(F.relu(self.se_fc1(y.mean((2, 3)))))
        y = y * torch.sigmoid(se)[:, :, None, None]
        x = x + self.bn3(self.project(y)).permute(0, 2, 3, 1)
        h = self.h
        dk = c // h
        t = x.reshape(b, hh * ww, c)
        q, k, v = (getattr(self, n)(t).reshape(b, -1, h, dk)
                   for n in ("att_q", "att_k", "att_v"))
        out = self.att_o(attend(q, k, v, dk).reshape(b, -1, c))
        return x + out.reshape(b, hh, ww, c)


class CABlock(nn.Module):
    """Coordinate attention, the CA_Block variant: H- and W-pooled strips
    through a shared ReLU bottleneck, separate F_h / F_w sigmoid gates."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        red = max(channels // reduction, 1)
        self.conv_1x1 = nn.Linear(channels, red, bias=False)
        self.F_h = nn.Linear(red, channels, bias=False)
        self.F_w = nn.Linear(red, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh = x.shape[1]
        cat = torch.cat([x.mean(2), x.mean(1)], dim=1)      # [B,H+W,C]
        cat = F.relu(self.conv_1x1(cat))
        s_h = torch.sigmoid(self.F_h(cat[:, :hh]))[:, :, None, :]
        s_w = torch.sigmoid(self.F_w(cat[:, hh:]))[:, None, :, :]
        return x * s_h * s_w


def _dct_filter(h: int, w: int, channel: int) -> np.ndarray:
    """Fixed 2-D DCT basis bank, the top-16 frequency selection."""
    top_x = [0, 0, 6, 0, 0, 1, 1, 4, 5, 1, 3, 0, 0, 0, 3, 2]
    top_y = [0, 1, 0, 5, 2, 0, 2, 0, 0, 6, 0, 4, 6, 3, 5, 2]
    num = 16
    while channel % num:
        num //= 2
    parts = channel // num

    def basis(pos, freq, size):
        r = math.cos(math.pi * freq * (pos + 0.5) / size) / math.sqrt(size)
        return r * (math.sqrt(2) if freq else 1.0)

    filt = np.zeros((h, w, channel), np.float32)
    for i in range(num):
        ux, vy = top_x[i] * (h // 7), top_y[i] * (w // 7)
        tile = np.asarray([[basis(tx, ux, h) * basis(ty, vy, w)
                            for ty in range(w)] for tx in range(h)],
                          np.float32)
        filt[:, :, i * parts:(i + 1) * parts] = tile[:, :, None]
    return filt


def _adaptive_pool_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] averaging matrix of adaptive_avg_pool1d's bins."""
    m = np.zeros((dst, src), np.float32)
    for i in range(dst):
        lo, hi = (i * src) // dst, -(-((i + 1) * src) // dst)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


class MultiSpectralAttention(nn.Module):
    """FcaNet multi-spectral channel attention: channel groups pooled by
    fixed 2-D DCT bases (top-16 frequencies) on the map adaptively pooled
    to 7x7 (two matmuls), then the SE MLP."""

    def __init__(self, channels: int, dct_size: int = 7,
                 reduction: int = 16):
        super().__init__()
        self.dct_size = dct_size
        red = max(channels // reduction, 1)
        self.fc1 = nn.Linear(channels, red, bias=False)
        self.fc2 = nn.Linear(red, channels, bias=False)
        self.register_buffer("dct", torch.from_numpy(
            _dct_filter(dct_size, dct_size, channels)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hh, ww = x.shape[1], x.shape[2]
        d = self.dct_size
        y = x
        if (hh, ww) != (d, d):
            ph, pw = (torch.as_tensor(_adaptive_pool_matrix(n, d),
                                      device=x.device, dtype=x.dtype)
                      for n in (hh, ww))
            y = torch.einsum("dh,bhwc,ew->bdec", ph, y, pw)
        pooled = (y * self.dct).sum((1, 2))                 # [B,C]
        s = self.fc2(F.relu(self.fc1(pooled)))
        return x * torch.sigmoid(s)[:, None, None]


class ResidualAttention(nn.Module):
    """Residual-attention multi-label scorer: per-pixel class evidence of
    a 1x1 conv, scored as the spatial mean + la · the spatial max. NOT
    shape-preserving: [B, num_classes]."""

    def __init__(self, channels: int, num_classes: int = 80,
                 la: float = 0.2):
        super().__init__()
        self.la = la
        self.fc = nn.Conv2d(channels, num_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        y = conv_nhwc(self.fc, x).reshape(b, hh * ww, -1)
        return y.mean(1) + self.la * y.amax(1)
