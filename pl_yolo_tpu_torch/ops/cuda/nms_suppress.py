"""Greedy NMS suppression: the wrapper of `csrc/nms_suppress.cu` and its
plain version.

Replaces the TPU kernel `pl_yolo_tpu/ops/pallas/nms_pallas.py::_nms_kernel`
(entry `pallas_suppress`). `nms_suppress(boxes, valid, iou_threshold)` takes
score-sorted boxes [B,K,4] fp32 xyxy (class offsets already added) and
valid [B,K] bool, and returns the greedy keep mask alive [B,K] bool.

A tensor on the CPU goes through the plain version (`suppress_plain`, the
IoU matrix and fixpoint of `ops.nms`); a tensor on the card launches the
kernel, on the current stream, or raises. The kernel's source note gives
its design and bound. `nms_suppress.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_K = 16384  # the kernel's limit (csrc/nms_suppress.cu kMaxK)


def suppress_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """The plain PyTorch version: greedy_suppress over the IoU matrix."""
    from ..nms import _iou_matrix, greedy_suppress
    return greedy_suppress(_iou_matrix(boxes), valid, iou_threshold)


def _library() -> ctypes.CDLL:
    lib = build.load("nms_suppress")
    fn = lib.nms_suppress
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
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
    _check(boxes, valid)
    if boxes.device.type == "cpu":
        return suppress_plain(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_suppress runs on cuda or cpu, not {boxes.device}")
    b, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"nms_suppress takes K <= {MAX_K}, got {k}")
    alive = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return alive
    mask = torch.empty((b, k, (k + 63) // 64), dtype=torch.int64,
                       device=boxes.device)
    lib = _library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.nms_suppress(boxes.data_ptr(), valid.data_ptr(),
                               mask.data_ptr(), alive.data_ptr(), b, k,
                               float(iou_threshold), stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress kernel launch failed: cudaError {err}")
    nms_suppress.launches += 1
    return alive


nms_suppress.launches = 0
