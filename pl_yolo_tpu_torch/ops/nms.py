"""Fixed-shape batched NMS and detection postprocessing, port of
`pl_yolo_tpu/ops/nms.py`.

  * Everything is fixed shape: confidence filtering is score masking, the
    JAX package's per-image vmap is a batch dimension, and the output is a
    dense [B, max_det] set of boxes, scores and classes plus a validity mask.
  * Greedy NMS runs on the top-`pre_nms_topk` candidates. The suppression
    step is `ops.cuda.nms_suppress`: a hand-written CUDA kernel for a tensor
    on the card, the plain `greedy_suppress` below for a CPU tensor.
  * The pre-NMS and max_det top-k are stable descending sorts, so that among
    equal scores the lower index comes first, as `lax.top_k` orders them.
  * Class-aware NMS shifts boxes per class (`box_offset_span`) so that
    cross-class pairs never overlap; the shift is one fp32 add, the same on
    every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from .cuda.nms_suppress import nms_suppress


class Detections(NamedTuple):
    boxes: torch.Tensor    # [B, max_det, 4] xyxy
    scores: torch.Tensor   # [B, max_det]
    classes: torch.Tensor  # [B, max_det] int32
    valid: torch.Tensor    # [B, max_det] bool


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] xyxy -> [..., K, K] IoU (plain IoU, torchvision
    semantics). The operation order is the JAX package's, so the fp32
    values are bit-identical to it."""
    tl = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    br = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0))
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS keep-mask given score-descending IoU [..., K, K].

    Row j survives iff no higher-scored surviving row overlaps it above the
    threshold. Computed, as in the JAX package, by iterating
        alive'[j] = valid[j] & !any_{i<j}(alive[i] & over[i,j])
    to its fixpoint: row 0 is final after one pass, and once rows < j are
    final row j is final on the next pass, so the fixpoint is the greedy
    solution. A batch iterates until every image has reached its fixpoint
    (a fixpoint maps to itself)."""
    k = iou.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)
    over = ((iou > iou_threshold) & upper).to(torch.float32)
    alive = valid
    for _ in range(k + 1):
        killed = (alive.to(torch.float32).unsqueeze(-2) @ over).squeeze(-2) > 0
        new = valid & ~killed
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-image gather along dim 1: x [B, A, ...], idx [B, k]."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _top_desc(scores: torch.Tensor, k: int):
    """Top-k along the last dim, descending, lower index first among ties."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Candidates(NamedTuple):
    """The top-`pre_nms_topk` candidates of each image, score-descending."""
    boxes: torch.Tensor      # [B, K, 4] xyxy
    scores: torch.Tensor     # [B, K], 0 below the confidence threshold
    classes: torch.Tensor    # [B, K] int32
    valid: torch.Tensor      # [B, K] bool: score > 0
    nms_boxes: torch.Tensor  # [B, K, 4] boxes shifted per class: the
                             # suppression step's input


def nms_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, conf_threshold: float = 0.01,
                   pre_nms_topk: int = 1024, class_agnostic: bool = False,
                   box_offset_span: float = 4096.0) -> Candidates:
    """Confidence masking, pre-NMS top-k and the class-offset shift."""
    scores = torch.where(scores >= conf_threshold, scores, 0.0)
    k = min(pre_nms_topk, scores.shape[1])
    top_scores, top_idx = _top_desc(scores, k)
    top_boxes = _take(boxes, top_idx)
    top_classes = _take(classes, top_idx)
    if class_agnostic:
        nms_boxes = top_boxes
    else:
        # class-offset trick: disjoint coordinate islands per class
        offset = top_classes.to(top_boxes.dtype) * box_offset_span
        nms_boxes = top_boxes + offset[..., None]
    return Candidates(top_boxes, top_scores, top_classes, top_scores > 0.0,
                      nms_boxes.contiguous())


def batched_nms(
    boxes: torch.Tensor,     # [B, A, 4] xyxy
    scores: torch.Tensor,    # [B, A]
    classes: torch.Tensor,   # [B, A] int32
    conf_threshold: float = 0.01,
    iou_threshold: float = 0.65,
    max_det: int = 300,
    pre_nms_topk: int = 1024,
    class_agnostic: bool = False,
    box_offset_span: float = 4096.0,
    merge: bool = False,
) -> Detections:
    """Batched class-aware NMS with fixed output shapes."""
    cand = nms_candidates(boxes, scores, classes, conf_threshold,
                          pre_nms_topk, class_agnostic, box_offset_span)
    top_boxes = cand.boxes
    alive = nms_suppress(cand.nms_boxes, cand.valid, iou_threshold)

    if merge:
        # merge-NMS: each kept box becomes the score-weighted average of
        # the candidates it suppressed
        k = cand.scores.shape[1]
        iou = _iou_matrix(cand.nms_boxes)
        w = torch.where((iou > iou_threshold) & cand.valid[:, None, :],
                        cand.scores[:, None, :], 0.0)
        w = w + torch.eye(k, dtype=w.dtype, device=w.device) * cand.scores[:, None, :]
        merged = (w @ top_boxes) / torch.clamp(w.sum(-1, keepdim=True),
                                               min=1e-12)
        top_boxes = torch.where(alive[..., None], merged, top_boxes)

    final_scores = torch.where(alive, cand.scores, 0.0)
    det_scores, det_idx = _top_desc(final_scores,
                                    min(max_det, final_scores.shape[1]))
    return Detections(
        boxes=_take(top_boxes, det_idx),
        scores=det_scores,
        classes=_take(cand.classes, det_idx),
        valid=det_scores > 0.0,
    )


def postprocess(
    predictions: torch.Tensor,  # [B, A, 5+C]: xyxy, obj, cls-probs (eval decode)
    conf_threshold: float = 0.01,
    iou_threshold: float = 0.65,
    max_det: int = 300,
    pre_nms_topk: int = 1024,
    class_agnostic: bool = False,
    multi_label: bool = False,
    merge: bool = False,
    device=None,
) -> Detections:
    """confidence = obj * max cls prob, class = argmax cls prob, then batched
    NMS capped at max_det. `multi_label`: every class above threshold is its
    own candidate instead of only the argmax. Runs on `device` (default the
    CUDA card; "cpu" runs the plain suppression)."""
    predictions = predictions.to(resolve_device(device))
    kw = dict(conf_threshold=conf_threshold, iou_threshold=iou_threshold,
              max_det=max_det, pre_nms_topk=pre_nms_topk,
              class_agnostic=class_agnostic, merge=merge)
    cls_probs = predictions[..., 5:]
    if multi_label:
        b, a, c = cls_probs.shape
        scores = (predictions[..., 4:5] * cls_probs).reshape(b, a * c)
        classes = torch.arange(c, dtype=torch.int32,
                               device=predictions.device).repeat(b, a)
        boxes = torch.repeat_interleave(predictions[..., :4], c, dim=1)
        return batched_nms(boxes, scores, classes, **kw)
    cls_conf, cls_pred = torch.max(cls_probs, dim=-1)
    confidence = predictions[..., 4] * cls_conf
    return batched_nms(predictions[..., :4], confidence,
                       cls_pred.to(torch.int32), **kw)
