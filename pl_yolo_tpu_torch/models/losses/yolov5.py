"""YOLOv5 anchor-based loss + decoder, port of
`pl_yolo_tpu/models/losses/yolov5.py`.

The classic 3-positive assignment: the candidate slab of the YOLOv7 loss
(`yolov7._find_positive_candidates`) without the OTA refinement, so every
candidate that passes the wh-ratio gate is a positive matched to its own
label. CIoU box loss, IoU-weighted obj BCE with per-level balance, cls BCE;
the loss is scaled by the batch size. The decode is YOLOv7's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ...parallel.mesh import data_sum, global_batch
from .yolov7 import (_bce_logits, _find_positive_candidates, _flat_index,
                     _level_means, _objectness, _positive_ciou,
                     flatten_v7_outputs, yolov7_eval_decode)

DEFAULT_V5_ANCHORS = (((10, 13), (16, 30), (33, 23)),
                      ((30, 61), (62, 45), (59, 119)),
                      ((116, 90), (156, 198), (373, 326)))


def yolov5_eval_decode(outputs, strides, anchors, num_classes):
    """The same decode as YOLOv7's."""
    return yolov7_eval_decode(outputs, strides, anchors, num_classes)


def yolov5_loss(
    outputs: Sequence[torch.Tensor],
    labels: torch.Tensor,              # [B, max_labels, 5] cls,cx,cy,w,h px
    num_classes: int,
    strides: Sequence[int] = (8, 16, 32),
    anchors=DEFAULT_V5_ANCHORS,
    anchor_threshold: float = 4.0,
    balance: Sequence[float] = (4.0, 1.0, 0.4),
    gain: dict | None = None,
) -> dict[str, torch.Tensor]:
    """Training loss, batched. `gain` overrides the top-level weights (keys
    box/obj/cls). A label slot is valid where its row sums > 0."""
    gain = gain or {}
    lambda_box = float(gain.get("box", 0.05))
    lambda_obj = float(gain.get("obj", 1.0))
    lambda_cls = float(gain.get("cls", 0.0375))

    shapes = tuple((o.shape[1], o.shape[2]) for o in outputs)
    d = flatten_v7_outputs(outputs, strides, anchors, num_classes)
    B = d.flat.shape[0]
    L = len(shapes)

    labels = labels.to(torch.float32)
    gt_valid = labels.sum(dim=2) > 0
    gt_classes = labels[..., 0].to(torch.int64)
    gt_boxes = labels[..., 1:5]
    M = gt_boxes.shape[1]

    with torch.no_grad():
        cells, ok, anchor_ids, level_ids = _find_positive_candidates(
            gt_boxes, gt_valid, shapes, strides, anchors,
            threshold=anchor_threshold)
        Ca = cells[0].numel() // 2
        cells, ok = cells.reshape(B, Ca, 2), ok.reshape(B, Ca)
        anchor_ids, level_ids = anchor_ids.reshape(B, Ca), level_ids.reshape(B, Ca)
        flat_idx = torch.where(ok, _flat_index(cells, anchor_ids, level_ids,
                                               shapes, d.level_sizes), 0)
        own_gt = torch.arange(M, device=labels.device).repeat_interleave(
            Ca // M)[None].expand(B, Ca)

    pred_pos, iou = _positive_ciou(
        d, flat_idx, own_gt, gt_boxes, cells.to(torch.float32),
        d.strides[flat_idx], d.anchor_wh[flat_idx])
    ok_f = ok.to(torch.float32)

    tgt_cls = gt_classes.gather(1, own_gt)
    onehot = F.one_hot(tgt_cls.clamp(0, num_classes - 1), num_classes).to(
        torch.float32) * ((tgt_cls >= 0) & (tgt_cls < num_classes))[..., None]
    cls_per_cand = _bce_logits(pred_pos[..., 5:], onehot).sum(dim=-1)

    box_loss = _level_means(1.0 - iou, level_ids, ok_f, L)
    cls_loss = (_level_means(cls_per_cand, level_ids, ok_f, L,
                             denom_scale=num_classes)
                if num_classes > 1 else 0.0)
    obj_loss = _objectness(d, flat_idx, iou, ok_f, balance)

    box_loss = box_loss * lambda_box
    obj_loss = obj_loss * lambda_obj
    cls_loss = cls_loss * lambda_cls
    # the global batch's B under data parallelism (parallel.mesh)
    loss = (box_loss + obj_loss + cls_loss) * global_batch(B)
    return {"loss": loss, "loss_iou": box_loss, "loss_obj": obj_loss,
            "loss_cls": torch.as_tensor(cls_loss, dtype=torch.float32,
                                        device=labels.device),
            "proportion": ok_f.sum() / data_sum(gt_valid.sum()).clamp(min=1)}
