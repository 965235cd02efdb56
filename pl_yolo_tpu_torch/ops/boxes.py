"""Box format conversions and the IoU family (port of
`pl_yolo_tpu/ops/boxes.py`, the part the YOLOX and anchor-based paths use).
Plain tensor functions over a trailing box dim of 4; leading dims
broadcast."""

from __future__ import annotations

import math

import torch


def xyxy2cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """[x1,y1,x2,y2] -> [cx,cy,w,h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    return torch.stack([x1 + w * 0.5, y1 + h * 0.5, w, h], dim=-1)


def cxcywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[cx,cy,w,h] -> [x1,y1,x2,y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)


def _area(xyxy: torch.Tensor) -> torch.Tensor:
    wh = (xyxy[..., 2:] - xyxy[..., :2]).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def _intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (br - tl).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                 fmt_cxcywh: bool = False) -> torch.Tensor:
    """Pairwise IoU [..., N, M] of boxes_a [..., N, 4] and boxes_b
    [..., M, 4] (xyxy unless `fmt_cxcywh`); leading dims are a batch."""
    if fmt_cxcywh:
        boxes_a = cxcywh2xyxy(boxes_a)
        boxes_b = cxcywh2xyxy(boxes_b)
    inter = _intersection(boxes_a[..., :, None, :], boxes_b[..., None, :, :])
    union = _area(boxes_a)[..., :, None] + _area(boxes_b)[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def elementwise_iou(pred: torch.Tensor, target: torch.Tensor,
                    fmt_cxcywh: bool = True, eps: float = 1e-16
                    ) -> torch.Tensor:
    """Elementwise IoU of aligned box tensors [..., 4]."""
    if fmt_cxcywh:
        pred = cxcywh2xyxy(pred)
        target = cxcywh2xyxy(target)
    inter = _intersection(pred, target)
    union = _area(pred) + _area(target) - inter
    return inter / union.clamp(min=eps)


def giou(pred: torch.Tensor, target: torch.Tensor, fmt_cxcywh: bool = True,
         eps: float = 1e-16) -> torch.Tensor:
    """Elementwise generalized IoU."""
    if fmt_cxcywh:
        pred = cxcywh2xyxy(pred)
        target = cxcywh2xyxy(target)
    inter = _intersection(pred, target)
    union = _area(pred) + _area(target) - inter
    iou = inter / union.clamp(min=eps)
    ctl = torch.minimum(pred[..., :2], target[..., :2])
    cbr = torch.maximum(pred[..., 2:], target[..., 2:])
    cwh = (cbr - ctl).clamp(min=0.0)
    c_area = (cwh[..., 0] * cwh[..., 1]).clamp(min=eps)
    return iou - (c_area - union) / c_area


def _enclosing_diag2_and_center_dist2(p: torch.Tensor, t: torch.Tensor,
                                      eps: float):
    """(squared diagonal of the enclosing box + eps, squared distance of
    the centres) of xyxy boxes."""
    cw = torch.maximum(p[..., 2], t[..., 2]) - torch.minimum(p[..., 0], t[..., 0])
    ch = torch.maximum(p[..., 3], t[..., 3]) - torch.minimum(p[..., 1], t[..., 1])
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((t[..., 0] + t[..., 2]) - (p[..., 0] + p[..., 2])) ** 2
            + ((t[..., 1] + t[..., 3]) - (p[..., 1] + p[..., 3])) ** 2) / 4.0
    return c2, rho2


def ciou(pred: torch.Tensor, target: torch.Tensor, fmt_cxcywh: bool = True,
         eps: float = 1e-7) -> torch.Tensor:
    """Elementwise complete IoU. The aspect term's weight `alpha` is a
    constant to autograd (computed under `no_grad`, the JAX package's
    `stop_gradient`)."""
    if fmt_cxcywh:
        p, t = cxcywh2xyxy(pred), cxcywh2xyxy(target)
    else:
        p, t = pred, target
    iou = elementwise_iou(p, t, fmt_cxcywh=False, eps=eps)
    pw = (p[..., 2] - p[..., 0]).clamp(min=eps)
    ph = (p[..., 3] - p[..., 1]).clamp(min=eps)
    tw = (t[..., 2] - t[..., 0]).clamp(min=eps)
    th = (t[..., 3] - t[..., 1]).clamp(min=eps)
    c2, rho2 = _enclosing_diag2_and_center_dist2(p, t, eps)
    v = (4.0 / math.pi ** 2) * (torch.atan(tw / th) - torch.atan(pw / ph)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1.0 + eps)).clamp(min=eps)
    return iou - (rho2 / c2 + v * alpha)


def diou(pred: torch.Tensor, target: torch.Tensor, fmt_cxcywh: bool = True,
         eps: float = 1e-7) -> torch.Tensor:
    """Elementwise distance IoU."""
    if fmt_cxcywh:
        p, t = cxcywh2xyxy(pred), cxcywh2xyxy(target)
    else:
        p, t = pred, target
    iou = elementwise_iou(p, t, fmt_cxcywh=False, eps=eps)
    c2, rho2 = _enclosing_diag2_and_center_dist2(p, t, eps)
    return iou - rho2 / c2


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             loss_type: str = "giou", fmt_cxcywh: bool = True
             ) -> torch.Tensor:
    """IoU losses, elementwise: 'iou' -> 1 - iou^2, 'giou' -> 1 - giou,
    'ciou' -> 1 - ciou, 'diou' -> 1 - diou."""
    if loss_type == "iou":
        iou = elementwise_iou(pred, target, fmt_cxcywh=fmt_cxcywh)
        return 1.0 - iou ** 2
    if loss_type == "giou":
        return 1.0 - giou(pred, target, fmt_cxcywh=fmt_cxcywh).clamp(-1.0, 1.0)
    if loss_type == "ciou":
        return 1.0 - ciou(pred, target, fmt_cxcywh=fmt_cxcywh)
    if loss_type == "diou":
        return 1.0 - diou(pred, target, fmt_cxcywh=fmt_cxcywh)
    raise ValueError(f"Unsupported iou loss type: {loss_type}")
