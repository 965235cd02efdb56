"""Separable bilinear warp of K tiles from a channel-major pool: the wrapper
of `csrc/mosaic_warp.cu` and its plain version.

Replaces the TPU kernel `pl_yolo_tpu/ops/pallas/mosaic_pallas.py::
_mosaic_kernel` (driven by `_warp_chw`). `mosaic_warp(pool, tidx, ox, oy,
xs, ys, hix, hiy, fill)` takes

* pool [N,3,H,W] bf16 or fp32, contiguous: the source images;
* tidx [B,K] integer: output b draws tile k from `pool[tidx[b, k]]`;
* ox, oy [B,K] integer: each tile's origin in window coordinates;
* xs [B,W], ys [B,H] float: each output column's and row's raw source
  coordinate in the window, valid on [0, hix-1] and [0, hiy-1];

and returns [B,3,H,W] in the pool's dtype: the bilinear sample of the K
tiles, blended towards `fill` where no tile covers a tap (the semantics in
the kernel's source note). The sum runs in fp32 and is rounded once.

A tensor on the CPU goes through the plain version (`warp_plain`); a
tensor on the card launches the kernel, on the current stream, or raises.
On the card the wrapper checks that every tile index lies in [0, N), which
reads the indices back to the host (one synchronisation a call). Pixels
must be finite: a tile whose taps all weigh 0 is skipped by the kernel,
where the plain version multiplies it by 0. `mosaic_warp.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_B = 65535  # the kernel's grid.z


def _taps(coords: torch.Tensor, origins: torch.Tensor, n: int, hi: int):
    """One axis of the kernel's taps for every (b, k): coords [B,L] raw,
    origins [B,K]. Returns clamped indices a0, a1 [B,K,L], weights w0, w1
    [B,K,L] and the coverage [B,L], as `_axis_taps` of the TPU kernel."""
    c = coords[:, None, :]
    v = ((c >= 0) & (c <= hi - 1)).to(torch.float32)
    csc = torch.clamp(c, 0.0, float(hi - 1))
    g0 = torch.floor(csc).to(torch.int32)
    f = csc - g0.to(torch.float32)
    g1 = g0 + 1
    org = origins.to(torch.int32)[:, :, None]
    a0, a1 = g0 - org, g1 - org
    in0 = ((a0 >= 0) & (a0 < n)).to(torch.float32)
    in1 = ((a1 >= 0) & (a1 < n)).to(torch.float32)
    w0 = (1.0 - f) * in0 * v
    w1 = f * in1 * v
    any0 = in0.amax(dim=1)
    any1 = in1.amax(dim=1)
    cov = ((1.0 - f[:, 0]) * any0 + f[:, 0] * any1) * v[:, 0]
    return (a0.clamp(0, n - 1).long(), a1.clamp(0, n - 1).long(), w0, w1,
            cov)


def warp_plain(pool: torch.Tensor, tidx: torch.Tensor, ox: torch.Tensor,
               oy: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
               hix: int, hiy: int, fill: float) -> torch.Tensor:
    """The plain PyTorch version: the kernel's taps and sums, operation for
    operation, on gathered [B,K,3,H,W] fp32 copies of the tiles."""
    _, _, h, w = pool.shape
    b, nk = tidx.shape
    xs = xs.to(torch.float32)
    ys = ys.to(torch.float32)
    y0, y1, wy0, wy1, covy = _taps(ys, oy, h, hiy)       # [B,K,H], [B,H]
    x0, x1, wx0, wx1, covx = _taps(xs, ox, w, hix)       # [B,K,W], [B,W]
    tiles = pool[tidx.long()].to(torch.float32)          # [B,K,3,H,W]

    def rows(idx):
        return torch.gather(tiles, 3, idx[:, :, None, :, None].expand(
            b, nk, 3, h, w))

    def cols(t, idx):
        return torch.gather(t, 4, idx[:, :, None, None, :].expand(
            b, nk, 3, h, w))

    wx0, wx1 = wx0[:, :, None, None, :], wx1[:, :, None, None, :]
    top, bot = rows(y0), rows(y1)
    r0 = cols(top, x0) * wx0 + cols(top, x1) * wx1
    r1 = cols(bot, x0) * wx0 + cols(bot, x1) * wx1
    contrib = (wy0[:, :, None, :, None] * r0
               + wy1[:, :, None, :, None] * r1)          # [B,K,3,H,W]
    acc = torch.zeros((b, 3, h, w), dtype=torch.float32, device=pool.device)
    for k in range(nk):
        acc = acc + contrib[:, k]
    cov = covy[:, :, None] * covx[:, None, :]
    return (acc + fill * (1.0 - cov)[:, None]).to(pool.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load("mosaic_warp")
    fn = lib.mosaic_warp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(pool, tidx, ox, oy, xs, ys, hix, hiy) -> None:
    if pool.dim() != 4 or pool.shape[1] != 3:
        raise ValueError(f"pool must be [N,3,H,W], got {tuple(pool.shape)}")
    if pool.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pool must be float32 or bfloat16, got {pool.dtype}")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous")
    _, _, h, w = pool.shape
    if tidx.dim() != 2 or tidx.shape[1] < 1:
        raise ValueError(f"tidx must be [B,K] with K >= 1, got "
                         f"{tuple(tidx.shape)}")
    b = tidx.shape[0]
    for name, t, shape in (("ox", ox, tidx.shape), ("oy", oy, tidx.shape),
                           ("xs", xs, (b, w)), ("ys", ys, (b, h))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("tidx", tidx), ("ox", ox), ("oy", oy)):
        if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
            raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")
    for name, t in (("xs", xs), ("ys", ys)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be a float tensor, got {t.dtype}")
    for t in (tidx, ox, oy, xs, ys):
        if t.device != pool.device:
            raise ValueError(f"all inputs must be on {pool.device}, one is "
                             f"on {t.device}")
    if hix < 1 or hiy < 1:
        raise ValueError(f"hix and hiy must be >= 1, got {hix}, {hiy}")


def mosaic_warp(pool: torch.Tensor, tidx: torch.Tensor, ox: torch.Tensor,
                oy: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                hix: int, hiy: int, fill: float) -> torch.Tensor:
    _check(pool, tidx, ox, oy, xs, ys, hix, hiy)
    if pool.device.type == "cpu":
        if tidx.numel() and not 0 <= int(tidx.min()) <= int(tidx.max()) \
                < pool.shape[0]:
            raise IndexError(f"tidx must lie in [0, {pool.shape[0]})")
        return warp_plain(pool, tidx, ox, oy, xs, ys, hix, hiy, fill)
    if pool.device.type != "cuda":
        raise ValueError(f"mosaic_warp runs on cuda or cpu, not {pool.device}")
    n, _, h, w = pool.shape
    b, nk = tidx.shape
    if b > MAX_B:
        raise ValueError(f"mosaic_warp takes B <= {MAX_B}, got {b}")
    out = torch.empty((b, 3, h, w), dtype=pool.dtype, device=pool.device)
    if b == 0:
        return out
    tidx, ox, oy = (t.to(torch.int32).contiguous() for t in (tidx, ox, oy))
    xs, ys = (t.to(torch.float32).contiguous() for t in (xs, ys))
    lo, hi = torch.stack(torch.aminmax(tidx)).tolist()
    if not 0 <= lo <= hi < n:
        raise IndexError(f"tidx must lie in [0, {n})")
    lib = _library()
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = lib.mosaic_warp(
            pool.data_ptr(), int(pool.dtype == torch.bfloat16),
            tidx.data_ptr(), ox.data_ptr(), oy.data_ptr(), xs.data_ptr(),
            ys.data_ptr(), out.data_ptr(), b, nk, h, w, hix, hiy,
            float(fill), stream)
    if err != 0:
        raise RuntimeError(f"mosaic_warp kernel launch failed: cudaError {err}")
    mosaic_warp.launches += 1
    return out


mosaic_warp.launches = 0
