"""Greedy NMS suppression: the wrapper of `csrc/nms_suppress.cu` and its
plain version.

Replaces the TPU kernel `pl_yolo_tpu/ops/pallas/nms_pallas.py::_nms_kernel`
(entry `pallas_suppress`). `nms_suppress(boxes, valid, iou_threshold)` takes
score-sorted boxes [B,K,4] fp32 xyxy (class offsets already added) and
valid [B,K] bool, and returns the greedy keep mask alive [B,K] bool.

A tensor on the CPU goes through the plain version (`suppress_plain`, the
IoU matrix and fixpoint of `ops.nms`); a tensor on the card launches the
kernel, on the current stream, or raises. The kernel's source note gives
its design and bound: up to `CLUSTER_MAX_K` candidates one launch of the
cluster kernel, which keeps the IoU bitmask in shared memory; above that,
up to `MAX_K`, the two-launch kernels with a mask scratch in device memory.
`nms_suppress.launches` counts the calls that launched, and
`nms_suppress.large_k_launches` those of them that took the two-launch path.

`ops.nms.suppress_op` registers this wrapper as the operator
`torch.ops.pl_yolo_tpu_torch.nms_suppress`, which a tracer records as one
node.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

MAX_K = 16384  # the kernel's limit (csrc/nms_suppress.cu kMaxK)
CLUSTER_MAX_K = 3584  # the cluster kernel's capacity (kClusterMaxK)


def suppress_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """The plain PyTorch version: greedy_suppress over the IoU matrix."""
    from ..nms import _iou_matrix, greedy_suppress
    return greedy_suppress(_iou_matrix(boxes), valid, iou_threshold)


# nms_suppress(boxes, valid, mask, alive, B, K, threshold, stream)
ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p)


@functools.cache
def _entry():
    """The library's `nms_suppress`, its argument types set once."""
    fn = build.load("nms_suppress").nms_suppress
    fn.argtypes = list(ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def cluster_fit(k: int) -> int:
    """How many 8-CTA clusters of the cluster kernel the current device
    holds at once at K's shared memory (cudaOccupancyMaxActiveClusters)."""
    fn = build.load("nms_suppress").nms_cluster_fit
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    n = fn(k)
    if n < 0:
        raise RuntimeError(f"nms_cluster_fit({k}) failed: cudaError {-n}")
    return n


def check_inputs(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B,K,4], got {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:2]:
        raise ValueError(f"valid must be {tuple(boxes.shape[:2])}, "
                         f"got {tuple(valid.shape)}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"boxes must be float32 and valid bool, got "
                        f"{boxes.dtype} and {valid.dtype}")
    if boxes.device != valid.device:
        raise ValueError(f"boxes on {boxes.device}, valid on {valid.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")


def nms_suppress(boxes: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    check_inputs(boxes, valid)
    if boxes.device.type == "cpu":
        return suppress_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_suppress runs on cuda or cpu, not {boxes.device}")
    b, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"nms_suppress takes K <= {MAX_K}, got {k}")
    dev = boxes.device
    alive = torch.empty((b, k), dtype=torch.bool, device=dev)
    if b == 0 or k == 0:
        return alive
    large_k = k > CLUSTER_MAX_K
    mask = (torch.empty((b, k, (k + 63) // 64), dtype=torch.int64, device=dev)
            if large_k else None)
    args = (boxes.data_ptr(), valid.data_ptr(),
            None if mask is None else mask.data_ptr(), alive.data_ptr(), b, k,
            float(iou_threshold), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = _entry()(*args)
    else:  # the kernel launches on the current device
        with torch.cuda.device(dev):
            err = _entry()(*args)
    if err != 0:
        raise RuntimeError(f"nms_suppress kernel launch failed: cudaError {err}")
    nms_suppress.launches += 1
    nms_suppress.large_k_launches += large_k
    return alive


nms_suppress.launches = 0
nms_suppress.large_k_launches = 0
