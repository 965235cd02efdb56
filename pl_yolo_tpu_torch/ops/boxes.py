"""Box format conversions (port of `pl_yolo_tpu/ops/boxes.py`, the part
the inference path uses)."""

from __future__ import annotations

import torch


def cxcywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[cx,cy,w,h] -> [x1,y1,x2,y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)
