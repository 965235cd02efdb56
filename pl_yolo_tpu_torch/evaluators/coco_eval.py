"""COCO-protocol mAP evaluator (host-side numpy).

Capability parity with the reference's vendored pycocotools COCOeval
(models/data/datasets/pycocotools/cocoeval.py:129-541) and COCOEvaluator
wrapper (models/evaluators/eval_coco.py:8-36), implemented from the COCO
evaluation protocol:

  * IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1 (101 points),
    area ranges all/small/medium/large, maxDets (1, 10, 100)
    (cocoeval.py Params, :513-541).
  * Per (image, category): detections sorted by score match greedily to the
    best remaining GT with IoU >= threshold (cocoeval.py evaluateImg).
  * accumulate(): precision envelope over sorted scores, sampled at the 101
    recall points; AP = mean over classes/thresholds with -1 for absent
    classes excluded (cocoeval.py:378-460).

Returns the standard 12 metrics; `summary` matches the familiar layout.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xywh(det: np.ndarray, gt: np.ndarray,
              iscrowd: np.ndarray | None = None) -> np.ndarray:
    """IoU matrix [D, G] for xywh boxes (maskApi bbIou semantics): for crowd
    GT columns the denominator is the detection area (IoA), so a detection
    fully inside a crowd region scores 1.0 against it
    (reference cocoeval.py:192-193 via maskUtils.iou's iscrowd argument)."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    dx1, dy1 = det[:, 0], det[:, 1]
    dx2, dy2 = det[:, 0] + det[:, 2], det[:, 1] + det[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    darea = (det[:, 2] * det[:, 3])[:, None]
    union = darea + (gt[:, 2] * gt[:, 3])[None] - inter
    if iscrowd is not None and np.any(iscrowd):
        union = np.where(np.asarray(iscrowd, bool)[None, :], darea, union)
    return inter / np.maximum(union, 1e-12)


class COCOMetrics(dict):
    @property
    def summary(self) -> str:
        rows = [
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", self["AP"]),
            ("Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]", self["AP50"]),
            ("Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]", self["AP75"]),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", self["APs"]),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", self["APm"]),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", self["APl"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]", self["AR1"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]", self["AR10"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]", self["AR100"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]", self["ARs"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]", self["ARm"]),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]", self["ARl"]),
        ]
        return "\n".join(f" {name} = {val:0.3f}" for name, val in rows)


def evaluate_coco(detections: list[dict], gts: list[dict],
                  max_dets: int = 100, iou_fn=None) -> COCOMetrics:
    """detections: COCO result dicts {image_id, category_id, bbox xywh, score}
    gts: GT dicts {image_id, category_id, bbox xywh, area?, ignore?}.
    iou_fn(dts, gts) -> [D, G] overrides the bbox IoU (e.g. mask IoU for
    iouType='segm').
    """
    finite = [d for d in detections
              if np.isfinite(d["score"]) and np.all(np.isfinite(d["bbox"]))]
    if len(finite) != len(detections):
        import warnings

        warnings.warn(f"dropped {len(detections) - len(finite)} non-finite "
                      "detections before evaluation", RuntimeWarning,
                      stacklevel=2)
        detections = finite
    det_by = defaultdict(list)
    for d in detections:
        det_by[(d["image_id"], d["category_id"])].append(d)
    gt_by = defaultdict(list)
    img_ids = set()
    cat_ids = set()
    for g in gts:
        gt_by[(g["image_id"], g["category_id"])].append(g)
        img_ids.add(g["image_id"])
        cat_ids.add(g["category_id"])
    for d in detections:
        img_ids.add(d["image_id"])
    img_ids = sorted(img_ids)
    cat_ids = sorted(cat_ids)
    T = len(IOU_THRS)
    areas = list(AREA_RNG.items())

    # per (cat, area, img): match; then accumulate per (cat, area)
    precision = -np.ones((T, len(REC_THRS), len(cat_ids), len(areas), len(MAX_DETS)))
    recall = -np.ones((T, len(cat_ids), len(areas), len(MAX_DETS)))

    for ci, cat in enumerate(cat_ids):
        # pre-compute per-image IoUs at full maxDet, then match per area range
        per_img = []
        for img in img_ids:
            # stable sort by -score (pycocotools argsort(..., kind='mergesort'))
            dts = sorted(det_by.get((img, cat), []), key=lambda d: -d["score"])
            dts = dts[:MAX_DETS[-1]]
            gts_ic = gt_by.get((img, cat), [])
            dboxes = np.asarray([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
            gboxes = np.asarray([g["bbox"] for g in gts_ic], np.float64).reshape(-1, 4)
            garea = np.asarray(
                [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts_ic])
            iscrowd = np.asarray([bool(g.get("iscrowd", 0)) for g in gts_ic],
                                 dtype=bool)
            # base ignore: iscrowd (reference cocoeval.py:115). We also honor
            # an explicit `ignore` field (deliberate superset: the reference
            # overwrites it, upstream-pycocotools dead-code quirk).
            gignore_base = np.asarray(
                [bool(g.get("ignore", False)) for g in gts_ic], bool) | iscrowd
            ious = (iou_fn(dts, gts_ic) if iou_fn is not None
                    else _iou_xywh(dboxes, gboxes, iscrowd))
            scores = np.asarray([d["score"] for d in dts])
            darea = dboxes[:, 2] * dboxes[:, 3]
            per_img.append((scores, ious, garea, gignore_base, iscrowd, darea))

        for ai, (aname, (amin, amax)) in enumerate(areas):
            for mi, md in enumerate(MAX_DETS):
                all_scores, all_matched, all_ignored = [], [], []
                npig = 0
                for scores, ious, garea, gig_base, iscrowd, darea in per_img:
                    gig_u = gig_base | (garea < amin) | (garea > amax)
                    npig += int((~gig_u).sum())
                    # sort GTs ignore-last (stable), as cocoeval.py:266 does:
                    # the match loop's break below relies on this ordering
                    gorder = np.argsort(gig_u, kind="mergesort")
                    gig = gig_u[gorder]
                    crowd = iscrowd[gorder]
                    k = min(md, len(scores))
                    s = scores[:k]
                    iou = ious[:k][:, gorder]
                    D, G = iou.shape
                    dt_m = -np.ones((T, D), np.int64)
                    gt_m = -np.ones((T, G), np.int64)
                    for ti, thr in enumerate(IOU_THRS):
                        for di in range(D):
                            best, bi = min(thr, 1 - 1e-10), -1
                            for gi in range(G):
                                # crowd GTs may be matched repeatedly
                                # (cocoeval.py:288-289)
                                if gt_m[ti, gi] >= 0 and not crowd[gi]:
                                    continue
                                # once matched to a real gt, don't switch to
                                # an ignored one (all later gts are ignored)
                                if bi > -1 and not gig[bi] and gig[gi]:
                                    break
                                # NaN-proof: `iou < best` is False for NaN,
                                # which would match everything
                                if not (iou[di, gi] >= best):
                                    continue
                                best, bi = iou[di, gi], gi
                            if bi >= 0:
                                dt_m[ti, di] = bi
                                gt_m[ti, bi] = di
                    # dt ignore: matched to ignored gt, or unmatched+outside area
                    dig = np.zeros((T, D), bool)
                    for ti in range(T):
                        for di in range(D):
                            if dt_m[ti, di] >= 0:
                                dig[ti, di] = gig[dt_m[ti, di]]
                            else:
                                dig[ti, di] = (darea[di] < amin) or (darea[di] > amax)
                    all_scores.append(s)
                    all_matched.append(dt_m >= 0)
                    all_ignored.append(dig)

                if npig == 0:
                    continue
                scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
                order = np.argsort(-scores, kind="mergesort")
                matched = (np.concatenate(all_matched, 1)[:, order]
                           if all_scores else np.zeros((T, 0), bool))
                ignored = (np.concatenate(all_ignored, 1)[:, order]
                           if all_scores else np.zeros((T, 0), bool))
                tps = matched & ~ignored
                fps = ~matched & ~ignored
                tp_sum = np.cumsum(tps, 1).astype(np.float64)
                fp_sum = np.cumsum(fps, 1).astype(np.float64)
                for ti in range(T):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[ti, ci, ai, mi] = rc[-1] if nd else 0.0
                    # precision envelope (monotone decreasing from the right)
                    q = np.zeros(len(REC_THRS))
                    pr = pr.tolist()
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    for ri, pi in enumerate(inds):
                        if pi < nd:
                            q[ri] = pr[pi]
                    precision[ti, :, ci, ai, mi] = q

    def _ap(t=None, area="all", md=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(md)
        p = precision[:, :, :, ai, mi]
        if t is not None:
            p = p[[int(np.argwhere(np.isclose(IOU_THRS, t))[0][0])]]
        p = p[p > -1]
        return float(np.mean(p)) if p.size else -1.0

    def _ar(area="all", md=100):
        ai = list(AREA_RNG).index(area)
        mi = MAX_DETS.index(md)
        r = recall[:, :, ai, mi]
        r = r[r > -1]
        return float(np.mean(r)) if r.size else -1.0

    m = COCOMetrics(
        AP=_ap(), AP50=_ap(0.5), AP75=_ap(0.75),
        APs=_ap(area="small"), APm=_ap(area="medium"), APl=_ap(area="large"),
        AR1=_ar(md=1), AR10=_ar(md=10), AR100=_ar(md=100),
        ARs=_ar(area="small"), ARm=_ar(area="medium"), ARl=_ar(area="large"),
    )
    # per-class AP (IoU 0.50:0.95, all areas, maxDets 100) — the COCO-side
    # analogue of the reference's per-class VOC table (eval_voc.py:155-209)
    ai0, mi100 = 0, MAX_DETS.index(100)
    per_class = {}
    for ci, cat in enumerate(cat_ids):
        p = precision[:, :, ci, ai0, mi100]
        p = p[p > -1]
        per_class[cat] = float(np.mean(p)) if p.size else float("nan")
    m.per_class_ap = per_class
    return m


class COCOeval:
    """Class API parity with the reference's vendored pycocotools COCOeval
    (cocoeval.py:11-551): COCOeval(cocoGt, cocoDt, iouType).evaluate()/
    accumulate()/summarize(), stats = the 12 standard metrics. iouType
    'bbox' uses box IoU; 'segm' uses the native RLE mask IoU."""

    def __init__(self, cocoGt=None, cocoDt=None, iouType: str = "bbox"):
        assert iouType in ("bbox", "segm"), f"unsupported iouType {iouType}"
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.iouType = iouType
        self.stats = None
        self._metrics: COCOMetrics | None = None
        self.params = type("Params", (), {
            "iouThrs": IOU_THRS, "recThrs": REC_THRS,
            "maxDets": list(MAX_DETS),
            "areaRng": [list(v) for v in AREA_RNG.values()],
            "areaRngLbl": list(AREA_RNG.keys()),
        })()

    def _mask_iou_fn(self):
        from . import mask_ops

        def fn(dts, gts):
            d = [self.cocoDt.annToRLE(a) if isinstance(a.get("segmentation"), (list, dict))
                 else a["segmentation"] for a in dts]
            g = [self.cocoGt.annToRLE(a) for a in gts]
            crowd = [a.get("iscrowd", 0) for a in gts]
            return mask_ops.iou(d, g, iscrowd=crowd)
        return fn

    def evaluate(self):
        gts = [dict(a) for a in self.cocoGt.dataset.get("annotations", [])]
        dts = [dict(a) for a in self.cocoDt.dataset.get("annotations", [])]
        iou_fn = self._mask_iou_fn() if self.iouType == "segm" else None
        self._metrics = evaluate_coco(dts, gts, iou_fn=iou_fn)

    def accumulate(self):
        if self._metrics is None:
            self.evaluate()

    def summarize(self):
        self.accumulate()
        m = self._metrics
        self.stats = np.asarray([
            m["AP"], m["AP50"], m["AP75"], m["APs"], m["APm"], m["APl"],
            m["AR1"], m["AR10"], m["AR100"], m["ARs"], m["ARm"], m["ARl"],
        ])
        print(m.summary)
        return self.stats


def coco_evaluator(json_list: list[dict], dataset) -> tuple[float, float, str]:
    """Reference COCOEvaluator signature (eval_coco.py:8-36): detections as
    COCO-json dicts + the dataset -> (AP, AP50, summary).

    GT comes from the dataset's raw json annotations (incl. iscrowd ignore
    regions) when available — matching the reference, which evaluates against
    the original cocoGt — with a letterbox-unscale fallback for datasets that
    keep only scaled boxes (e.g. VOC-as-COCO)."""
    names = {cid: n for cid, n in zip(
        getattr(dataset, "class_ids", []),
        getattr(dataset, "class_names", []))}
    gts = getattr(dataset, "eval_annotations", None)
    if gts is None:
        gts = []
        for boxes, classes, h, w, img_id in dataset.annotations:
            r = min(dataset.img_size[0] / h, dataset.img_size[1] / w)
            for b, c in zip(boxes, classes):
                ob = b / r  # stored boxes are letterbox-scaled; undo for eval
                gts.append({
                    "image_id": int(img_id),
                    "category_id": int(dataset.class_ids[int(c)]),
                    "bbox": [float(ob[0]), float(ob[1]),
                             float(ob[2] - ob[0]), float(ob[3] - ob[1])],
                })
    if not json_list:
        return 0.0, 0.0, "no detections"
    m = evaluate_coco(json_list, gts)
    summary = m.summary
    per_class = getattr(m, "per_class_ap", None)
    if per_class:
        # per-class AP table (the COCO-side analogue of the reference's
        # per-class VOC report, eval_voc.py:155-209)
        rows = [f" {names.get(cid, cid):>24} | {ap:0.3f}"
                for cid, ap in sorted(per_class.items())
                if np.isfinite(ap)]
        if rows:
            summary += ("\n per-class AP (IoU=0.50:0.95):\n"
                        + "\n".join(rows))
    return m["AP"], m["AP50"], summary
