"""YOLOX grid decode, port of the eval half of
`pl_yolo_tpu/models/losses/yolox.py` (`yolox_decode`, `yolox_eval_decode`).

Anchor a at (row y, col x) of a level has shifts (x, y) and decodes as
xy = (raw_xy + (x, y)) * stride, wh = exp(raw_wh) * stride; anchors are
level-major with 'ij' grids within a level. Decode math runs in fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ...ops.boxes import cxcywh2xyxy


class DecodeOut(NamedTuple):
    preds: torch.Tensor       # [B, A, 5+C] decoded (cxcywh abs, obj/cls logits)
    ori_boxes: torch.Tensor   # [B, A, 4] raw reg outputs (for the L1 loss)
    x_shifts: torch.Tensor    # [A]
    y_shifts: torch.Tensor    # [A]
    strides: torch.Tensor     # [A]


def yolox_decode(outputs: Sequence[torch.Tensor],
                 strides: Sequence[int]) -> DecodeOut:
    """Decode per-level NHWC head maps [B,H,W,5+C] into flat predictions."""
    preds, oris, xs, ys, ss = [], [], [], [], []
    for level, stride in zip(outputs, strides):
        level = level.float()
        b, h, w, c = level.shape
        flat = level.reshape(b, h * w, c)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=flat.dtype, device=flat.device),
            torch.arange(w, dtype=flat.dtype, device=flat.device),
            indexing="ij")
        gx = gx.reshape(-1)
        gy = gy.reshape(-1)
        xy = (flat[..., :2] + torch.stack([gx, gy], dim=-1)[None]) * stride
        wh = torch.exp(flat[..., 2:4]) * stride
        preds.append(torch.cat([xy, wh, flat[..., 4:]], dim=-1))
        oris.append(flat[..., :4])
        xs.append(gx)
        ys.append(gy)
        ss.append(torch.full((h * w,), float(stride), dtype=flat.dtype,
                             device=flat.device))
    return DecodeOut(
        preds=torch.cat(preds, dim=1),
        ori_boxes=torch.cat(oris, dim=1),
        x_shifts=torch.cat(xs),
        y_shifts=torch.cat(ys),
        strides=torch.cat(ss),
    )


def yolox_eval_decode(outputs: Sequence[torch.Tensor],
                      strides: Sequence[int]) -> torch.Tensor:
    """Eval branch: sigmoid obj/cls, boxes as xyxy -> [B, A, 5+C]."""
    d = yolox_decode(outputs, strides)
    boxes = cxcywh2xyxy(d.preds[..., :4])
    scores = torch.sigmoid(d.preds[..., 4:])
    return torch.cat([boxes, scores], dim=-1)
