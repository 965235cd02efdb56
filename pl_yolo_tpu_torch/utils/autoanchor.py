"""Dataset-driven anchor priors for the anchor-based family (v7/v5/v3).

The reference pins the COCO-640 anchor table in every yolov5/yolov7 config
(reference configs/model/yolov7/*.yaml; models/losses/yolov7/yolov7_loss.py:24
consumes it verbatim) and has NO re-estimation step — training on any other
scale/domain silently runs with unmatched priors (the find-3-positive wh gate
at yolov7_loss.py:330-335 rejects gts outside 4x of every anchor). This module
is a deliberate beyond-reference addition: IoU-metric k-means over the
dataset's GT box sizes, in the spirit of ultralytics' autoanchor, so the
accuracy gate (tools/accuracy_gate.py) can exercise the anchor-based losses
with matchable priors on its 160 px synthetic set.

Pure numpy, host-side, one-shot at config time — nothing here traces.
"""

from __future__ import annotations

import json

import numpy as np


def _iou_wh(whs: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Pairwise IoU of origin-anchored boxes. whs [N,2], centroids [K,2]."""
    inter = (np.minimum(whs[:, None, 0], centroids[None, :, 0])
             * np.minimum(whs[:, None, 1], centroids[None, :, 1]))
    union = (whs[:, 0] * whs[:, 1])[:, None] \
        + (centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def kmeans_anchors(whs, n_levels: int = 3, per_level: int = 3,
                   iters: int = 50, seed: int = 0):
    """K-means (1 - IoU distance) over GT [w, h] pixels.

    Returns anchors as a tuple of n_levels tuples of per_level (w, h)
    pairs, sorted by area ascending (small anchors on the high-res
    level), matching the layout yolov7_loss/yolov5_loss expect.
    """
    whs = np.asarray(whs, np.float64).reshape(-1, 2)
    whs = whs[(whs > 1.0).all(axis=1)]
    k = n_levels * per_level
    if len(whs) < k:
        raise ValueError(f"need >= {k} labeled boxes, got {len(whs)}")
    rng = np.random.default_rng(seed)
    # k-means++ style spread: start from area quantiles (deterministic,
    # robust on the small synthetic sets the gate uses)
    order = np.argsort(whs[:, 0] * whs[:, 1])
    centroids = whs[order[np.linspace(0, len(whs) - 1, k).astype(int)]].copy()
    centroids += rng.uniform(-1e-3, 1e-3, centroids.shape)  # break ties
    for _ in range(iters):
        assign = np.argmax(_iou_wh(whs, centroids), axis=1)
        new = centroids.copy()
        for j in range(k):
            sel = whs[assign == j]
            if len(sel):
                new[j] = np.median(sel, axis=0)
        if np.allclose(new, centroids, rtol=1e-4):
            centroids = new
            break
        centroids = new
    area_order = np.argsort(centroids[:, 0] * centroids[:, 1])
    centroids = centroids[area_order]
    levels = tuple(
        tuple((round(float(w), 2), round(float(h), 2))
              for w, h in centroids[i * per_level:(i + 1) * per_level])
        for i in range(n_levels))
    return levels


def dataset_anchors(ann_json: str, n_levels: int = 3, per_level: int = 3,
                    img_size=None, seed: int = 0):
    """Anchors from a COCO-format annotation file's bbox whs.

    img_size: optional (W, H) the model trains at — whs are scaled from
    each image's native size so the anchors live in model-input pixels
    (the loss divides by stride straight from config;
    models/losses/yolov7.py::flatten_v7_outputs).
    """
    with open(ann_json) as f:
        coco = json.load(f)
    dims = {im["id"]: (im["width"], im["height"]) for im in coco["images"]}
    whs = []
    for ann in coco["annotations"]:
        w, h = ann["bbox"][2], ann["bbox"][3]
        if img_size is not None:
            iw, ih = dims[ann["image_id"]]
            s = min(img_size[0] / iw, img_size[1] / ih)  # letterbox scale
            w, h = w * s, h * s
        whs.append((w, h))
    return kmeans_anchors(whs, n_levels, per_level, seed=seed)
