"""Auxiliary host-side augmentations: copy-paste, cut-paste, cutout-rounding,
and the object/background bank extractor.

Capability parity with reference models/data/augmentation/copypaste.py:7-46,
cutpaste.py:6-38, cutout_round.py:6-55 and background.py:4-46 — wired
CORRECTLY: the reference's MosaicDetection references dataset attributes
(`object_cls`/`back_cls`) that are never set, so copypaste/cutpaste would
AttributeError if enabled (mosaic_detection.py:87-89, SURVEY.md §"Known
reference bugs"). Here the banks are built by `extract_banks` and passed
explicitly.

These run host-side in the loader (they're probability-gated extras, off in
every shipped config); the hot augmentations (mosaic/affine/mixup/HSV/flip)
run on device (data/augment.py).
"""

from __future__ import annotations

import numpy as np


def _bbox_ioa(box: np.ndarray, boxes: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection over `boxes` area (reference bbox.py bbox_ioa)."""
    if len(boxes) == 0:
        return np.zeros(0)
    iw = np.clip(np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]), 0, None)
    ih = np.clip(np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]), 0, None)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) + eps
    return iw * ih / area


def _valid_xyxy(labels: np.ndarray) -> np.ndarray:
    """Padded [M,5] cxcywh labels -> [n,5] (cls + xyxy) of valid rows."""
    v = labels.sum(1) > 0
    lab = labels[v]
    out = np.zeros_like(lab)
    out[:, 0] = lab[:, 0]
    out[:, 1] = lab[:, 1] - lab[:, 3] / 2
    out[:, 2] = lab[:, 2] - lab[:, 4] / 2
    out[:, 3] = lab[:, 1] + lab[:, 3] / 2
    out[:, 4] = lab[:, 2] + lab[:, 4] / 2
    return out


def extract_banks(dataset, num_classes: int, max_per_class: int = 50,
                  patch: int = 64, rng=None):
    """Build per-class object-crop and background-patch banks
    (reference getBackground, background.py:4-46).

    Returns (object_bank: list[list[(img, w, h)]], background_bank: list[img]).
    Object crops keep native size; background patches are `patch`x`patch`
    cut from image corners/edges away from boxes."""
    rng = rng or np.random.default_rng(0)
    object_bank = [[] for _ in range(num_classes)]
    background_bank = []
    order = rng.permutation(len(dataset))
    for idx in order:
        img, labels, _, _ = dataset[int(idx)]
        lab = _valid_xyxy(labels)
        for cls, x1, y1, x2, y2 in lab:
            c = int(cls)
            if len(object_bank[c]) >= max_per_class:
                continue
            xi1, yi1, xi2, yi2 = map(int, (x1, y1, x2, y2))
            if xi2 - xi1 >= 4 and yi2 - yi1 >= 4:
                object_bank[c].append(img[yi1:yi2, xi1:xi2].copy())
        # edge background patches (no box overlap); adapt patch size to image
        h, w = img.shape[:2]
        p = min(patch, h // 3, w // 3)
        if len(background_bank) < max_per_class and p >= 8:
            for _ in range(4):
                x = int(rng.integers(0, w - p))
                y = int(rng.integers(0, h - p))
                cand = np.array([x, y, x + p, y + p], np.float32)
                if len(lab) == 0 or (_bbox_ioa(cand, lab[:, 1:5]) < 0.05).all():
                    background_bank.append(img[y:y + p, x:x + p].copy())
        if (all(len(b) >= max_per_class for b in object_bank)
                and len(background_bank) >= max_per_class):
            break
    return object_bank, background_bank


def copy_paste(img: np.ndarray, labels: np.ndarray, object_bank,
               scale=(0.5, 1.5), max_paste: int = 3, ioa_thr: float = 0.2,
               rng=None):
    """Paste random object crops at IOA<0.2 spots and append their labels
    (reference copypaste.py:7-46). img is modified in place."""
    rng = rng or np.random.default_rng()
    from PIL import Image
    h, w = img.shape[:2]
    lab = _valid_xyxy(labels)
    existing = lab[:, 1:5].copy() if len(lab) else np.zeros((0, 4), np.float32)
    n_valid = int((labels.sum(1) > 0).sum())
    classes = [c for c, bank in enumerate(object_bank) if bank]
    if not classes:
        return img, labels
    for _ in range(max_paste):
        if n_valid >= len(labels):
            break
        c = int(rng.choice(classes))
        crop = object_bank[c][int(rng.integers(0, len(object_bank[c])))]
        s = float(rng.uniform(*scale))
        cw = max(int(crop.shape[1] * s), 2)
        chh = max(int(crop.shape[0] * s), 2)
        if cw >= w or chh >= h:
            continue
        crop_r = np.asarray(Image.fromarray(crop).resize((cw, chh)))
        x = int(rng.integers(0, w - cw))
        y = int(rng.integers(0, h - chh))
        box = np.array([x, y, x + cw, y + chh], np.float32)
        if len(existing) and (_bbox_ioa(box, existing) >= ioa_thr).any():
            continue
        img[y:y + chh, x:x + cw] = crop_r
        labels[n_valid] = [c, x + cw / 2, y + chh / 2, cw, chh]
        existing = np.concatenate([existing, box[None]], 0)
        n_valid += 1
    return img, labels


def cut_paste(img: np.ndarray, background_bank, max_paste: int = 2, rng=None):
    """Paste background patches 50/50 blended (reference cutpaste.py:6-38)."""
    rng = rng or np.random.default_rng()
    if not background_bank:
        return img
    h, w = img.shape[:2]
    for _ in range(max_paste):
        patch = background_bank[int(rng.integers(0, len(background_bank)))]
        ph, pw = patch.shape[:2]
        if ph >= h or pw >= w:
            continue
        x = int(rng.integers(0, w - pw))
        y = int(rng.integers(0, h - ph))
        img[y:y + ph, x:x + pw] = (
            img[y:y + ph, x:x + pw].astype(np.uint16) + patch) // 2
    return img


def cutout_rounding(img: np.ndarray, labels: np.ndarray, max_cut: int = 4,
                    ioa_thr: float = 0.3, rng=None):
    """Cutouts filled with the surrounding mean color, skipped when they
    would cover a box beyond IOA 0.3 (reference cutout_round.py:6-55)."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    lab = _valid_xyxy(labels)
    boxes = lab[:, 1:5] if len(lab) else np.zeros((0, 4), np.float32)
    for _ in range(max_cut):
        cw = int(rng.integers(w // 16, w // 4))
        ch = int(rng.integers(h // 16, h // 4))
        x = int(rng.integers(0, w - cw))
        y = int(rng.integers(0, h - ch))
        cand = np.array([x, y, x + cw, y + ch], np.float32)
        if len(boxes) and (_bbox_ioa(cand, boxes) >= ioa_thr).any():
            continue
        # surrounding mean color (pad-1 ring around the hole)
        x0, y0 = max(x - 2, 0), max(y - 2, 0)
        x1, y1 = min(x + cw + 2, w), min(y + ch + 2, h)
        ring = img[y0:y1, x0:x1].astype(np.float32)
        img[y:y + ch, x:x + cw] = ring.mean(axis=(0, 1)).astype(np.uint8)
    return img


def make_host_augment(transform_cfg: dict, dataset, num_classes: int,
                      seed: int = 96):
    """Wire the extras by config probs; returns callable (img, labels) ->
    (img, labels) or None when all probs are zero."""
    cp = float(transform_cfg.get("copypaste_prob", 0))
    ctp = float(transform_cfg.get("cutpaste_prob", 0))
    cor = float(transform_cfg.get("cutoutR_prob", 0))
    if cp <= 0 and ctp <= 0 and cor <= 0:
        return None
    rng = np.random.default_rng(seed)
    obj_bank, bg_bank = extract_banks(dataset, num_classes, rng=rng)
    scale = tuple(transform_cfg.get("copypaste_scale", (0.5, 1.5)))

    def augment(img, labels):
        img = np.ascontiguousarray(img)
        labels = labels.copy()
        if cp > 0 and rng.uniform() < cp:
            img, labels = copy_paste(img, labels, obj_bank, scale=scale, rng=rng)
        if ctp > 0 and rng.uniform() < ctp:
            img = cut_paste(img, bg_bank, rng=rng)
        if cor > 0 and rng.uniform() < cor:
            img = cutout_rounding(img, labels, rng=rng)
        return img, labels
    return augment
