"""Box format conversions and the IoU family (port of
`pl_yolo_tpu/ops/boxes.py`, the part the YOLOX paths use). Plain tensor
functions over a trailing box dim of 4; leading dims broadcast."""

from __future__ import annotations

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


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             loss_type: str = "giou", fmt_cxcywh: bool = True
             ) -> torch.Tensor:
    """IoU losses, elementwise: 'iou' -> 1 - iou^2, 'giou' -> 1 - giou.
    ('ciou' and 'diou' belong to the anchor families and are not ported.)"""
    if loss_type == "iou":
        iou = elementwise_iou(pred, target, fmt_cxcywh=fmt_cxcywh)
        return 1.0 - iou ** 2
    if loss_type == "giou":
        return 1.0 - giou(pred, target, fmt_cxcywh=fmt_cxcywh).clamp(-1.0, 1.0)
    raise ValueError(f"Unsupported iou loss type: {loss_type}")
