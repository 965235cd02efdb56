"""Generate a nontrivial synthetic detection dataset (COCO layout).

Purpose: a reproducible learning-validation benchmark that goes beyond
tiny-overfit smoke tests (no real COCO data is mounted in this environment).
Shape — not color — is the class cue: every object gets a random color, so
the model must learn geometry. Backgrounds are textured (random sinusoid
fields + noise), objects are rotated, scales span 5x, and images carry
unlabeled speckle clutter.

Classes: 0=disc (filled circle + contrasting ring), 1=box (rotated filled
rectangle with border), 2=tri (rotated filled triangle).

Hard mode (--hard): six classes — the three above plus 3=cross (two
perpendicular rotated bars), 4=star (5-point angular-modulated radius) and
5=ring (annulus: confusable with disc unless the model sees the hollow
center) — plus real occlusion (objects drawn in z-order may cover up to
~60% of an earlier object; boxes keep the full analytic extent) and a
wider scale span (16..0.55*size). This is the round-3 accuracy-regression
benchmark (ROADMAP "larger shapes/val benchmark").

Usage:
  python -m pl_yolo_tpu_torch.tools.make_shapes_dataset --root /tmp/shapes \
      --n-train 400 --n-val 100 --size 320 [--hard]

Writes <root>/{train,val}/ images and <root>/annotations/instances_%s.json,
matching the COCO datamodule schema (configs/data/shapes_demo.yaml).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
from PIL import Image


def _background(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        base = rng.uniform(40, 200)
        field = np.zeros((h, w), np.float32)
        for _ in range(3):
            fx, fy = rng.uniform(0.5, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.uniform(5, 30)
            field += amp * np.sin(2 * np.pi * fx * xx / w + ph[0]) \
                         * np.sin(2 * np.pi * fy * yy / h + ph[1])
        img[..., c] = base + field
    img += rng.normal(0, 6, (h, w, 3))
    # unlabeled speckle clutter: a few tiny bright/dark dots
    for _ in range(int(rng.integers(5, 15))):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(1.0, 3.0)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        img[d2 < r * r] = rng.uniform(0, 255, 3)
    return img, xx, yy


def _object_mask(rng, cls, xx, yy, cx, cy, s):
    """Analytic mask + inner 'detail' mask for one object; returns
    (mask, detail, tight bbox xyxy)."""
    th = rng.uniform(0, 2 * np.pi)
    u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
    v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
    if cls == 0:                                   # disc + ring
        r = s / 2
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        mask = d2 <= r * r
        detail = (d2 <= r * r) & (d2 >= (0.7 * r) ** 2)
    elif cls == 1:                                 # rotated rectangle
        a, b = s / 2, s / 2 * rng.uniform(0.5, 1.0)
        mask = (np.abs(u) <= a) & (np.abs(v) <= b)
        detail = mask & ((np.abs(u) >= 0.8 * a) | (np.abs(v) >= 0.8 * b))
    elif cls == 2:                                 # rotated triangle
        r = s / 2
        mask = np.ones_like(xx, bool)
        for k in range(3):
            ang = th + 2 * np.pi * k / 3
            nx_, ny_ = np.cos(ang), np.sin(ang)
            mask &= ((xx - cx) * nx_ + (yy - cy) * ny_) <= r * 0.5
        detail = np.zeros_like(mask)
    elif cls == 3:                                 # cross: two rotated bars
        a, b = s / 2, s / 2 * rng.uniform(0.2, 0.35)
        mask = ((np.abs(u) <= a) & (np.abs(v) <= b)) \
             | ((np.abs(v) <= a) & (np.abs(u) <= b))
        detail = np.zeros_like(mask)
    elif cls == 4:                                 # 5-point star
        r = s / 2
        ang = np.arctan2(v, u)
        rad = np.hypot(u, v)
        # radius modulated between inner and outer radius, 5 lobes
        rmax = r * (0.45 + 0.55 * (0.5 + 0.5 * np.cos(5 * ang)))
        mask = rad <= rmax
        detail = np.zeros_like(mask)
    else:                                          # ring (annulus)
        r = s / 2
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        mask = (d2 <= r * r) & (d2 >= (0.55 * r) ** 2)
        detail = (d2 <= r * r) & (d2 >= (0.85 * r) ** 2)
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return None
    return mask, detail, (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)


CLASSES_V1 = ["disc", "box", "tri"]
CLASSES_HARD = CLASSES_V1 + ["cross", "star", "ring"]


def make_split(root: Path, split: str, n_images: int, size: int, seed: int,
               hard: bool = False):
    rng = np.random.default_rng(seed)
    img_dir = root / split
    img_dir.mkdir(parents=True, exist_ok=True)
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    h = w = size
    names = CLASSES_HARD if hard else CLASSES_V1
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        img, xx, yy = _background(rng, h, w)
        n_obj = int(rng.integers(2, 10)) if hard else int(rng.integers(1, 7))
        for _ in range(n_obj):
            cls = int(rng.integers(0, len(names)))
            s = (float(rng.uniform(16, 0.55 * size)) if hard
                 else float(rng.uniform(24, 120)))
            cx = rng.uniform(s / 2, w - s / 2)
            cy = rng.uniform(s / 2, h - s / 2)
            got = _object_mask(rng, cls, xx, yy, cx, cy, s)
            if got is None:
                continue
            mask, detail, (x0, y0, x1, y1) = got
            color = rng.uniform(0, 255, 3)
            # guarantee some contrast against the local background
            local = img[int(cy) - 2:int(cy) + 2, int(cx) - 2:int(cx) + 2]
            if local.size and np.abs(color - local.mean((0, 1))).sum() < 120:
                color = 255.0 - color
            img[mask] = color
            img[detail] = 255.0 - color
            bw, bh = int(x1 - x0), int(y1 - y0)
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": cls + 1,
                "bbox": [int(x0), int(y0), bw, bh], "area": bw * bh,
                "iscrowd": 0, "segmentation": [],
            })
            ann_id += 1
        fname = f"{split}_{i:05d}.jpg"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            img_dir / fname, quality=92)
        images.append({"id": i + 1, "file_name": fname,
                       "height": h, "width": w})
    doc = {
        "images": images, "annotations": annotations,
        "categories": [{"id": c + 1, "name": n}
                       for c, n in enumerate(names)],
    }
    with open(root / "annotations" / f"instances_{split}.json", "w") as f:
        json.dump(doc, f)
    print(f"{split}: {n_images} images, {len(annotations)} objects")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--n-train", type=int, default=400)
    ap.add_argument("--n-val", type=int, default=100)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hard", action="store_true",
                    help="6 classes + occlusion + wider scale span")
    args = ap.parse_args()
    make_split(args.root, "train", args.n_train, args.size, args.seed,
               hard=args.hard)
    make_split(args.root, "val", args.n_val, args.size, args.seed + 1,
               hard=args.hard)


if __name__ == "__main__":
    main()
