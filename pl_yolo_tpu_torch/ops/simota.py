"""The fused SimOTA assignment (port of `pl_yolo_tpu/ops/pallas/
simota_pallas.py`'s entry).

`simota_assign_fused` runs `ops.cuda.simota.simota_fused`: the hand-written
kernel on CUDA tensors, its plain version on CPU tensors. The TPU kernel's
padding of M, A and C to its tiles has no counterpart here.
"""

from __future__ import annotations

import torch

from .cuda.simota import simota_fused


def simota_assign_fused(gt_boxes, gt_classes, gt_valid, pred_boxes,
                        obj_logits, cls_logits, x_shifts, y_shifts, strides,
                        center_radius: float = 2.5):
    """Batched SimOTA assignment, with the signature of the JAX package's
    `simota_assign_pallas`: gt_boxes [B,M,4] cxcywh, gt_classes [B,M]
    integer, gt_valid [B,M], pred_boxes [B,A,4] cxcywh, obj_logits [B,A],
    cls_logits [B,A,C], x/y_shifts and strides [A]. Returns (fg_mask [B,A]
    bool, matched_gt [B,A] int64, pred_ious [B,A] fp32). Inputs are cast as
    the JAX entry casts them (floats to fp32); the prediction tensors may be
    strided views with unit stride along their last dim."""
    f32 = torch.float32
    return simota_fused(
        gt_boxes.to(f32), gt_classes.to(torch.int64).contiguous(),
        gt_valid.to(torch.bool).contiguous(), pred_boxes.to(f32),
        obj_logits.to(f32), cls_logits.to(f32),
        x_shifts.to(f32).contiguous(), y_shifts.to(f32).contiguous(),
        strides.to(f32).contiguous(), center_radius=center_radius)
