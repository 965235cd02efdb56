"""Detection visualization (PIL-based).

Capability parity with reference utils/visualize.py:11-128 (cv2 box/label
drawer + 80-color palette) and the missing-at-import COCOVisualization the
reference references but never ships (pl_detection.py:13 imports
utils.visualize_images which does not exist — a known reference bug fixed
here, SURVEY.md §3.4)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

def color_for(idx: int) -> tuple[int, int, int]:
    """Deterministic 80-ish color palette (reference visualize.py palette)."""
    return (int(37 * idx + 17) % 256, int(91 * idx + 53) % 256,
            int(151 * idx + 101) % 256)


def draw_detections(image: np.ndarray, boxes, scores, classes,
                    class_names=None, score_thr: float = 0.3) -> np.ndarray:
    """image: uint8 [H,W,3] RGB; boxes xyxy. Returns a drawn copy."""
    from PIL import Image, ImageDraw
    img = Image.fromarray(np.asarray(image, np.uint8))
    draw = ImageDraw.Draw(img)
    for box, score, cls in zip(boxes, scores, classes):
        if score < score_thr:
            continue
        c = color_for(int(cls))
        x1, y1, x2, y2 = [float(v) for v in box]
        draw.rectangle([x1, y1, x2, y2], outline=c, width=2)
        name = (class_names[int(cls)] if class_names
                and int(cls) < len(class_names) else str(int(cls)))
        label = f"{name} {score:.2f}"
        ty = max(y1 - 11, 0)
        draw.rectangle([x1, ty, x1 + 6 * len(label), ty + 11], fill=c)
        draw.text((x1 + 1, ty), label, fill=(255, 255, 255))
    return np.asarray(img)


def coco_visualization(json_list, dataset, out_dir: str = "./show",
                       score_thr: float = 0.3, class_names=None):
    """Dump per-image visualizations for a COCO-style result list
    (the reference's intended-but-missing COCOVisualization)."""
    from PIL import Image
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    by_img: dict[int, list] = {}
    for d in json_list:
        by_img.setdefault(d["image_id"], []).append(d)
    id_to_index = {dataset.annotations[i][4]: i for i in range(len(dataset))}
    cat_to_idx = {cid: i for i, cid in enumerate(dataset.class_ids)}
    count = 0
    for img_id, dets in by_img.items():
        if img_id not in id_to_index:
            continue
        idx = id_to_index[img_id]
        with Image.open(dataset._img_path(idx)) as im:
            img = np.asarray(im.convert("RGB"))
        boxes = [[d["bbox"][0], d["bbox"][1],
                  d["bbox"][0] + d["bbox"][2], d["bbox"][1] + d["bbox"][3]]
                 for d in dets]
        scores = [d["score"] for d in dets]
        classes = [cat_to_idx.get(d["category_id"], 0) for d in dets]
        drawn = draw_detections(img, boxes, scores, classes,
                                class_names=class_names, score_thr=score_thr)
        Image.fromarray(drawn).save(out / f"{img_id}.jpg")
        count += 1
    return count
