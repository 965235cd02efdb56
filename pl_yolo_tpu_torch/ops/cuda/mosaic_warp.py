"""Separable bilinear warp of K tiles from a channel-major pool: the wrapper
of `csrc/mosaic_warp.cu` and its plain version.

Replaces the TPU kernel `pl_yolo_tpu/ops/pallas/mosaic_pallas.py::
_mosaic_kernel` (driven by `_warp_chw`). `mosaic_warp(pool, tidx, ox, oy,
xs, ys, hix, hiy, fill)` takes

* pool [N,3,H,W] bf16 or fp32, contiguous: the source images;
* tidx [B,K] integer: output b draws tile k from `pool[tidx[b, k]]`;
* ox, oy [B,K] integer: each tile's origin in window coordinates, or both
  None: every origin 0 (the K=1 mixup warp);
* xs [B,W], ys [B,H] float: each output column's and row's raw source
  coordinate in the window, valid on [0, hix-1] and [0, hiy-1];

and returns [B,3,H,W] in the pool's dtype: the bilinear sample of the K
tiles, blended towards `fill` where no tile covers a tap (the semantics in
the kernel's source note). The sum runs in fp32 and is rounded once.

A tensor on the CPU goes through the plain version (`warp_plain`); a
tensor on the card launches the kernel, on the current stream, or raises.
The kernel takes the dtypes the augmentation holds (int64 tidx, int32
origins, fp32 coordinates); others are converted first. A tile index
outside [0, N) raises `IndexError` on the CPU. On the card the wrapper
reads nothing back to the host, so a call can be captured in a CUDA graph:
the kernel never reads such a tile, sets a flag on the card instead, and
the wrapper asserts the flag on the card's timeline (`torch._assert_async`),
so the run stops with a device-side assert at its next synchronisation.
Every other check needs only shapes, dtypes and devices and raises at
once. Pixels must be finite: a tile whose taps all weigh 0 is skipped by
the kernel, where the plain version multiplies it by 0.
`mosaic_warp.launches` counts kernel launches.
"""

from __future__ import annotations

import contextlib
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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                   i32, i32, i32, i32, i32, ctypes.c_float, ptr]
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
    if h * w >= 2 ** 31:
        raise ValueError(f"pool planes must hold < 2^31 pixels, got {h}x{w}")
    b = tidx.shape[0]
    if (ox is None) != (oy is None):
        raise ValueError("ox and oy must both be tensors or both be None")
    origins = () if ox is None else (("ox", ox), ("oy", oy))
    for name, t, shape in (*((n, t, tidx.shape) for n, t in origins),
                           ("xs", xs, (b, w)), ("ys", ys, (b, h))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("tidx", tidx), *origins):
        if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
            raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")
    for name, t in (("xs", xs), ("ys", ys)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be a float tensor, got {t.dtype}")
    for t in (tidx, *(t for _, t in origins), xs, ys):
        if t.device != pool.device:
            raise ValueError(f"all inputs must be on {pool.device}, one is "
                             f"on {t.device}")
    if hix < 1 or hiy < 1:
        raise ValueError(f"hix and hiy must be >= 1, got {hix}, {hiy}")


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t as a contiguous tensor of `dtype`, converted only where it is not
    one already (the augmentation's tensors are: no call on the host)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


# one int32 a card, held at 1; the kernel writes 0 on a tile index outside
# [0, N), and then the run is over (a device-side assert)
_OK: dict[torch.device, torch.Tensor] = {}


def _ok_flag(device: torch.device) -> torch.Tensor:
    if device not in _OK:
        _OK[device] = torch.ones(1, dtype=torch.int32, device=device)
    return _OK[device]


def mosaic_warp(pool: torch.Tensor, tidx: torch.Tensor,
                ox: torch.Tensor | None, oy: torch.Tensor | None,
                xs: torch.Tensor, ys: torch.Tensor,
                hix: int, hiy: int, fill: float) -> torch.Tensor:
    _check(pool, tidx, ox, oy, xs, ys, hix, hiy)
    if pool.device.type == "cpu":
        if tidx.numel() and not 0 <= int(tidx.min()) <= int(tidx.max()) \
                < pool.shape[0]:
            raise IndexError(f"tidx must lie in [0, {pool.shape[0]})")
        if ox is None:
            ox = oy = torch.zeros(tidx.shape, dtype=torch.int32)
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
    tidx = _as(tidx, torch.int64)
    if ox is not None:
        ox, oy = _as(ox, torch.int32), _as(oy, torch.int32)
    xs, ys = _as(xs, torch.float32), _as(ys, torch.float32)
    ok = _ok_flag(pool.device)
    lib = _library()
    with (torch.cuda.device(pool.device)
          if pool.device.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = lib.mosaic_warp(
            pool.data_ptr(), int(pool.dtype == torch.bfloat16), n,
            tidx.data_ptr(), None if ox is None else ox.data_ptr(),
            None if oy is None else oy.data_ptr(), xs.data_ptr(),
            ys.data_ptr(), out.data_ptr(), ok.data_ptr(), b, nk, h, w, hix,
            hiy, float(fill), stream)
    if err != 0:
        raise RuntimeError(f"mosaic_warp kernel launch failed: cudaError {err}")
    torch._assert_async(ok)  # a tile index outside [0, N) ends the run here
    mosaic_warp.launches += 1
    return out


mosaic_warp.launches = 0
