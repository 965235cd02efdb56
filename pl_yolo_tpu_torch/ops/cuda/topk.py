"""Row top-k values: the wrapper of `csrc/topk_rows.cu` and its plain version.

Replaces the TPU kernel `pl_yolo_tpu/ops/pallas/topk_pallas.py::_topk_kernel`
(entry `topk_pallas`). `topk_rows(x, k)` takes x [..., A] of any float type
and returns the k largest values along the last dim, descending, duplicates
included, as [..., k] in x's dtype (selected in fp32, as the TPU kernel
does); `1 <= k <= 16 < A < 2^31`. The result equals
`torch.topk(x, k, dim=-1).values` bit for bit for finite and `-inf` entries;
NaN inputs are outside the contract, as in the TPU kernel (the kernel skips
NaN entries and ends a row that runs short with NaN).

A tensor on the CPU goes through the plain version (`topk_plain`); a tensor
on the card launches the kernel, on the current stream, or raises. The
result carries no autograd history: the TPU kernel has no VJP either (its
callers sit under `stop_gradient`). The kernel's source note gives its
design and bound. `topk_rows.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

MAX_K = 16  # the kernel's largest k (csrc/topk_rows.cu kMaxK)


def topk_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The plain PyTorch version: the distinct-value extraction of the TPU
    kernel, step by step. Per pass: the row max, the count of its ties, that
    many output slots filled with it, all its ties erased; k passes always
    suffice, since a pass fills at least one slot or the row is exhausted
    (all `-inf`, which then fills the rest)."""
    *lead, a = x.shape
    cur = x.detach().reshape(-1, a).to(torch.float32)
    rows = cur.shape[0]
    kio = torch.arange(k, device=x.device)[None, :]
    filled = torch.zeros((rows, 1), dtype=torch.int64, device=x.device)
    out = torch.full((rows, k), -torch.inf, dtype=torch.float32,
                     device=x.device)
    for _ in range(k):
        m = cur.amax(dim=1, keepdim=True)
        tie = cur == m
        cnt = tie.sum(dim=1, keepdim=True)
        put = (kio >= filled) & (kio < filled + cnt)
        out = torch.where(put, m, out)
        filled = filled + cnt
        cur = torch.where(tie, -torch.inf, cur)
    return out.reshape(*lead, k).to(x.dtype)


@functools.cache
def _kernel():
    """The C entry of `csrc/topk_rows.cu`, built and typed on first use."""
    fn = build.load("topk_rows").topk_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def topk_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    if not x.is_floating_point():
        raise TypeError(f"topk_rows takes a float tensor, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("topk_rows takes a tensor of at least one dim")
    a = x.shape[-1]
    if not 1 <= k <= MAX_K < a:
        raise ValueError(f"topk_rows takes 1 <= k <= {MAX_K} < A, got k={k}, "
                         f"A={a}")
    if x.device.type == "cpu":
        return topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk_rows runs on cuda or cpu, not {x.device}")
    xr = x.detach().reshape(-1, a).to(torch.float32).contiguous()
    rows = xr.shape[0]
    if rows >= 2 ** 31 or a >= 2 ** 31:
        raise ValueError(f"topk_rows takes fewer than 2^31 rows and entries "
                         f"a row, got {rows} x {a}")
    out = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    if rows > 0:
        kernel = _kernel()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = kernel(xr.data_ptr(), out.data_ptr(), rows, a, k, stream)
        if err != 0:
            raise RuntimeError(
                f"topk_rows kernel launch failed: cudaError {err}")
        topk_rows.launches += 1
    return out.reshape(*x.shape[:-1], k).to(x.dtype)


topk_rows.launches = 0
