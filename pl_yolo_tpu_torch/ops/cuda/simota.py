"""Fused SimOTA assignment: the wrapper of `csrc/simota_assign.cu` and its
plain version.

Replaces the TPU kernel `pl_yolo_tpu/ops/pallas/simota_pallas.py::
_simota_kernel` (entry `simota_assign_pallas`). `simota_fused(gt_boxes,
gt_classes, gt_valid, pred_boxes, obj_logits, cls_logits, x_shifts,
y_shifts, strides, center_radius)` takes

* gt_boxes [B,M,4] fp32 cxcywh, gt_classes [B,M] int64 (clipped to
  [0, C-1]), gt_valid [B,M] bool;
* pred_boxes [B,A,4] fp32 cxcywh, obj_logits [B,A] fp32, cls_logits [B,A,C]
  fp32;
* x_shifts, y_shifts, strides [A] fp32;

and returns (fg [B,A] bool, matched [B,A] int64, pred_iou [B,A] fp32): the
SimOTA assignment of the port's dense path (`models/losses/yolox.py::
simota_assign`), computed without any [B,M,A] tensor. Where the dense path
leaves a sum's order to a library reduction, the kernel fixes one (see its
source note) and the plain version `simota_fused_plain` repeats it, so the
two agree bit for bit; against the dense path they differ only where an
ulp of S or of the top-10 IoU sum flips a tie. A NaN cost ranks as +inf and
claims nothing (the dense path's argmin would pick it).

A tensor on the CPU goes through the plain version; a tensor on the card
launches the kernel, on the current stream, or raises. The label and
prediction tensors may be strided views (the loss passes slices of its
[B,A,5+C] predictions) with unit stride along the box and class dims; the
classes, validity and anchors must be contiguous. The result carries no
autograd history: the TPU kernel has no VJP either (its callers sit under
`stop_gradient`). `simota_fused.launches` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import build

TOPK = 10  # SimOTA's top-k: dynamic_k <= 10
# the cost's additive penalties (the dense path's too): outside box-and-centre,
# and a non-candidate anchor or an invalid label
CENTER_PENALTY = 100000.0
INVALID_PENALTY = 1e9
MAX_B = 65535  # the kernel's grid.y
MAX_A = 65535 * 512  # the label pass's grid.y of 512-anchor chunks


def _class_p(logit: torch.Tensor, sig_obj: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sigmoid(logit) * sig_obj).clamp(1e-8, 1.0 - 1e-8)


def simota_fused_plain(gt_boxes, gt_classes, gt_valid, pred_boxes,
                       obj_logits, cls_logits, x_shifts, y_shifts, strides,
                       center_radius: float = 2.5):
    """The plain PyTorch version: the kernel's arithmetic and order of
    operations on [B,M,A] tensors. Not meant to be fast."""
    b, m, _ = gt_boxes.shape
    a, c = cls_logits.shape[1:]
    xc = ((x_shifts + 0.5) * strides)[None, None, :]            # [1,1,A]
    yc = ((y_shifts + 0.5) * strides)[None, None, :]
    rad = (center_radius * strides)[None, None, :]
    gx, gy, gw, gh = (t[..., None] for t in gt_boxes.unbind(-1))  # [B,M,1]
    gx1, gy1 = gx - gw * 0.5, gy - gh * 0.5
    gx2, gy2 = gx + gw * 0.5, gy + gh * 0.5
    valid = gt_valid[..., None]
    in_box = torch.minimum(torch.minimum(xc - gx1, gx2 - xc),
                           torch.minimum(yc - gy1, gy2 - yc)) > 0.0
    in_center = torch.minimum(
        torch.minimum(xc - (gx - rad), (gx + rad) - xc),
        torch.minimum(yc - (gy - rad), (gy + rad) - yc)) > 0.0
    in_box, in_center = in_box & valid, in_center & valid
    fg_cand = (in_box | in_center).any(dim=1)                  # [B,A]
    cand = valid & fg_cand[:, None, :]                         # [B,M,A]

    # the class terms: S adds log(1 - p_c) for c = 0..C-1 in order from 0
    sig_obj = torch.sigmoid(obj_logits)
    acc = torch.zeros_like(sig_obj)
    for k in range(c):
        acc = acc + torch.log1p(-_class_p(cls_logits[..., k], sig_obj))
    s_all = -acc
    idx = gt_classes.clamp(0, c - 1)[..., None].expand(b, m, a)
    p = _class_p(torch.gather(cls_logits.transpose(1, 2), 1, idx),
                 sig_obj[:, None, :])
    cls_cost = (s_all[:, None, :] - torch.log(p)) + torch.log1p(-p)

    px, py, pw, ph = (t[:, None, :] for t in pred_boxes.unbind(-1))  # [B,1,A]
    px1, py1 = px - pw * 0.5, py - ph * 0.5
    px2, py2 = px + pw * 0.5, py + ph * 0.5
    g_area = (gx2 - gx1).clamp(min=0.0) * (gy2 - gy1).clamp(min=0.0)
    p_area = (px2 - px1).clamp(min=0.0) * (py2 - py1).clamp(min=0.0)
    inter = ((torch.minimum(gx2, px2) - torch.maximum(gx1, px1)).clamp(min=0.0)
             * (torch.minimum(gy2, py2) - torch.maximum(gy1, py1)).clamp(min=0.0))
    iou = inter / ((g_area + p_area) - inter).clamp(min=1e-12)
    iou = torch.where(cand, iou, 0.0)
    cost = (cls_cost + 3.0 * -torch.log(iou + 1e-8)
            + CENTER_PENALTY * ~(in_box & in_center)
            + INVALID_PENALTY * ~cand)

    # dynamic_k: the 10 largest IoUs (NaN ranks as -inf) added from 0 in
    # descending order; the threshold: the k-th smallest cost (NaN as +inf)
    top = torch.topk(torch.where(torch.isnan(iou), -torch.inf, iou), TOPK,
                     dim=-1).values
    total = torch.zeros_like(top[..., 0])
    for k in range(TOPK):
        total = total + top[..., k]
    dynamic_k = torch.where(total >= 1.0, total.clamp(max=float(TOPK)),
                            1.0).to(torch.int64)
    key = torch.where(torch.isnan(cost), torch.inf, cost)
    low = torch.topk(key, TOPK, dim=-1, largest=False).values
    kth = low.gather(-1, dynamic_k[..., None] - 1)
    matching = (cost <= kth) & cand

    # an anchor claimed more than once goes to its argmin-cost label (the
    # first minimum), if that label is a candidate
    n_claims = matching.sum(dim=1)
    first = matching.to(torch.uint8).argmax(dim=1)
    argmin = key.argmin(dim=1)
    multi = n_claims > 1
    pick = torch.where(multi, argmin, first)
    fg = torch.where(multi, cand.gather(1, argmin[:, None])[:, 0],
                     n_claims == 1)
    matched = torch.where(fg, pick, 0)
    pred_iou = torch.where(fg, iou.gather(1, pick[:, None])[:, 0], 0.0)
    return fg, matched, pred_iou


def _library() -> ctypes.CDLL:
    lib = build.load("simota_assign")
    fn = lib.simota_assign
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([ptr, i64, i64, ptr, ptr, ptr, i64, i64, ptr, i64, i64,
                    ptr, i64, i64, ptr, ptr, ptr, i32, i32, i32, i32,
                    ctypes.c_float, ptr, ptr, ptr, ptr, ptr])
    fn.restype = ctypes.c_int
    size = lib.simota_workspace_floats
    size.argtypes = [i32, i32, i32]
    size.restype = ctypes.c_longlong
    return lib


def _check(gt_boxes, gt_classes, gt_valid, pred_boxes, obj_logits,
           cls_logits, x_shifts, y_shifts, strides):
    floats = {"gt_boxes": gt_boxes, "pred_boxes": pred_boxes,
              "obj_logits": obj_logits, "cls_logits": cls_logits,
              "x_shifts": x_shifts, "y_shifts": y_shifts, "strides": strides}
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"simota_fused takes fp32 {name}, got {t.dtype}")
    if gt_classes.dtype != torch.int64:
        raise TypeError(f"simota_fused takes int64 gt_classes, got "
                        f"{gt_classes.dtype}")
    if gt_valid.dtype != torch.bool:
        raise TypeError(f"simota_fused takes bool gt_valid, got "
                        f"{gt_valid.dtype}")
    if gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4 \
            or cls_logits.dim() != 3:
        raise ValueError(f"simota_fused takes gt_boxes [B,M,4] and cls_logits "
                         f"[B,A,C], got {tuple(gt_boxes.shape)} and "
                         f"{tuple(cls_logits.shape)}")
    b, m, _ = gt_boxes.shape
    a, c = cls_logits.shape[1:]
    want = {"gt_classes": (gt_classes, (b, m)), "gt_valid": (gt_valid, (b, m)),
            "pred_boxes": (pred_boxes, (b, a, 4)),
            "obj_logits": (obj_logits, (b, a)), "x_shifts": (x_shifts, (a,)),
            "y_shifts": (y_shifts, (a,)), "strides": (strides, (a,))}
    for name, (t, shape) in want.items():
        got = tuple(t.shape)
        if got != shape:
            raise ValueError(f"simota_fused: {name} is {got}, expected {shape}")
    if m < 1 or c < 1 or a < TOPK:
        raise ValueError(f"simota_fused takes M >= 1, C >= 1 and A >= {TOPK}, "
                         f"got M={m}, C={c}, A={a}")
    return b, m, a, c


def simota_fused(gt_boxes, gt_classes, gt_valid, pred_boxes, obj_logits,
                 cls_logits, x_shifts, y_shifts, strides,
                 center_radius: float = 2.5):
    args = (gt_boxes, gt_classes, gt_valid, pred_boxes, obj_logits,
            cls_logits, x_shifts, y_shifts, strides)
    b, m, a, c = _check(*args)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"simota_fused takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        with torch.no_grad():
            return simota_fused_plain(*args, center_radius=center_radius)
    if device.type != "cuda":
        raise ValueError(f"simota_fused runs on cuda or cpu, not {device}")
    for name, t in (("gt_boxes", gt_boxes), ("pred_boxes", pred_boxes),
                    ("cls_logits", cls_logits)):
        if t.stride(-1) != 1:
            raise ValueError(f"simota_fused takes {name} with unit stride in "
                             f"its last dim, got strides {t.stride()}")
    for name, t in (("gt_classes", gt_classes), ("gt_valid", gt_valid),
                    ("x_shifts", x_shifts), ("y_shifts", y_shifts),
                    ("strides", strides)):
        if not t.is_contiguous():
            raise ValueError(f"simota_fused takes a contiguous {name}")
    if b > MAX_B or b * m >= 2 ** 31 or a > MAX_A:
        raise ValueError(f"simota_fused takes B <= {MAX_B}, B*M < 2^31 and "
                         f"A <= {MAX_A}, got B={b}, M={m}, A={a}")
    fg = torch.empty((b, a), dtype=torch.bool, device=device)
    matched = torch.empty((b, a), dtype=torch.int64, device=device)
    pred_iou = torch.empty((b, a), dtype=torch.float32, device=device)
    if b == 0:
        return fg, matched, pred_iou
    lib = _library()
    workspace = torch.empty(lib.simota_workspace_floats(b, m, a),
                            dtype=torch.float32, device=device)
    with (torch.cuda.device(device)
          if device.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.simota_assign(
            gt_boxes.data_ptr(), gt_boxes.stride(0), gt_boxes.stride(1),
            gt_classes.data_ptr(), gt_valid.data_ptr(),
            pred_boxes.data_ptr(), pred_boxes.stride(0), pred_boxes.stride(1),
            obj_logits.data_ptr(), obj_logits.stride(0), obj_logits.stride(1),
            cls_logits.data_ptr(), cls_logits.stride(0), cls_logits.stride(1),
            x_shifts.data_ptr(), y_shifts.data_ptr(), strides.data_ptr(),
            b, m, a, c, float(center_radius), workspace.data_ptr(),
            fg.data_ptr(), matched.data_ptr(), pred_iou.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"simota_assign kernel launch failed: cudaError "
                           f"{err}")
    simota_fused.launches += 1
    return fg, matched, pred_iou


simota_fused.launches = 0
