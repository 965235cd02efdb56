"""VOC-style per-class AP evaluator (host-side, vectorized numpy).

Capability parity with reference models/evaluators/eval_voc.py:7-209: greedy
per-class TP/FP matching at a fixed IoU, PR-curve-area AP, and a per-class
text report. The reference shards matching over an 8-process Pool
(eval_voc.py:16-31); here the matching is vectorized numpy (the host has the
evaluator's IoU matrices well in cache; no process pool needed).
"""

from __future__ import annotations

import numpy as np


def _iou_xyxy(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    tl = np.maximum(det[:, None, :2], gt[None, :, :2])
    br = np.minimum(det[:, None, 2:4], gt[None, :, 2:4])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    a2 = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    return inter / np.maximum(a1[:, None] + a2[None] - inter, 1e-12)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> float:
    """PR-curve AP (reference eval_voc.py:108-152): 'area' = all-points
    interpolated area under the envelope; '11points' = VOC07 style."""
    if mode == "area":
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    ap = 0.0
    for t in np.arange(0.0, 1.1, 0.1):
        prec = precisions[recalls >= t]
        ap += (prec.max() if prec.size else 0.0) / 11.0
    return float(ap)


def voc_evaluator(det_list, gt_list, iou_thr: float = 0.5,
                  class_names=None) -> tuple[float, str]:
    """det_list[img][cls] = np.ndarray [N,5] (x1,y1,x2,y2,score);
    gt_list[img][cls] = np.ndarray [M,4]. Returns (mAP, report)."""
    num_images = len(gt_list)
    num_classes = len(gt_list[0]) if num_images else 0
    aps, n_gts, n_dets = [], [], []
    for c in range(num_classes):
        scores, tps = [], []
        total_gt = 0
        total_det = 0
        for i in range(num_images):
            gt = gt_list[i][c]
            det = det_list[i][c] if i < len(det_list) else np.empty((0, 5))
            total_gt += len(gt)
            total_det += len(det)
            if len(det) == 0:
                continue
            order = np.argsort(-det[:, 4], kind="mergesort")
            det = det[order]
            tp = np.zeros(len(det), bool)
            if len(gt):
                iou = _iou_xyxy(det[:, :4], gt)
                taken = np.zeros(len(gt), bool)
                for d in range(len(det)):
                    gi = int(np.argmax(iou[d]))
                    if iou[d, gi] >= iou_thr and not taken[gi]:
                        taken[gi] = True
                        tp[d] = True
            scores.append(det[:, 4])
            tps.append(tp)
        n_gts.append(total_gt)
        n_dets.append(total_det)
        if total_gt == 0:
            aps.append(np.nan)
            continue
        if not scores:
            aps.append(0.0)
            continue
        scores = np.concatenate(scores)
        tps = np.concatenate(tps)
        order = np.argsort(-scores, kind="mergesort")
        tps = tps[order]
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(~tps)
        recalls = tp_cum / total_gt
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, np.spacing(1))
        aps.append(average_precision(recalls, precisions))

    valid = [a for a in aps if not np.isnan(a)]
    mAP = float(np.mean(valid)) if valid else 0.0
    names = class_names or [f"class{i}" for i in range(num_classes)]
    width = max([len(str(n)) for n in names] + [5])
    lines = [f"{'class':<{width}}  {'gts':>6}  {'dets':>6}  {'ap':>6}"]
    for c in range(num_classes):
        ap_str = "  --  " if np.isnan(aps[c]) else f"{aps[c]:0.4f}"
        lines.append(f"{names[c]:<{width}}  {n_gts[c]:>6}  {n_dets[c]:>6}  {ap_str:>6}")
    lines.append(f"{'mAP':<{width}}  {'':>6}  {'':>6}  {mAP:0.4f}")
    return mAP, "\n".join(lines)
