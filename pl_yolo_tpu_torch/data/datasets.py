"""Host-side datasets: COCO-json and VOC-xml detection datasets.

Capability parity with reference models/data/datasets/cocoDataset.py:9-174
and vocDataset.py:8-173, without cv2/pycocotools dependencies:

  * COCO json is parsed directly (the reference routes through its vendored
    pycocotools COCO class, cocoDataset.py:24; the evaluator-side COCO API
    lives in pl_yolo_tpu/evaluators/coco_api.py).
  * Annotations are pre-scaled to the letterbox ratio at init
    (cocoDataset.py:105-106) and stored as fixed-shape [max_labels, 5]
    = [cls, cx, cy, w, h] arrays (the reference's TrainTransform label
    contract, data_augments.py:44-46).
  * Images decode via PIL -> aspect-preserving resize -> top-left paste on a
    114-gray canvas (preproc, data_augments.py:90-106). Output is RGB
    (the reference is BGR via cv2 — irrelevant for from-scratch training,
    noted for parity audits).
  * Optional full RAM cache of decoded uint8 images (cocoDataset.py:137-158).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

FILL = 114


def letterbox_image(img: "Image.Image", target_hw: tuple[int, int]) -> tuple[np.ndarray, float]:
    """Aspect-preserving resize + top-left paste on gray canvas.
    Returns (uint8 [H,W,3], ratio)."""
    th, tw = target_hw
    w, h = img.size
    r = min(th / h, tw / w)
    nw, nh = int(w * r), int(h * r)
    resized = img.resize((max(nw, 1), max(nh, 1)), Image.BILINEAR)
    canvas = np.full((th, tw, 3), FILL, dtype=np.uint8)
    canvas[:nh, :nw] = np.asarray(resized.convert("RGB"), dtype=np.uint8)[:nh, :nw]
    return canvas, r


class DetectionDataset:
    """Common fixed-shape sample contract shared by COCO and VOC datasets.

    Subclasses fill: self.ids, self.annotations (list of
    (boxes_xyxy_scaled, classes, orig_h, orig_w, img_id)), self._img_path(i).
    """

    def __init__(self, img_size=(640, 640), max_labels: int = 100,
                 cache: bool = False):
        self.img_size = tuple(img_size)
        self.max_labels = max_labels
        self.cache = cache
        self._cache_store: dict[int, np.ndarray] = {}
        self._disk_cache = None

    def attach_disk_cache(self, cache_dir, workers: int = 4,
                          force: bool = False) -> None:
        """Serve images from a pre-letterboxed uint8 memmap (building it on
        first use) instead of decoding JPEGs per epoch — the scalable
        replacement for the reference's full-RAM ThreadPool cache
        (cocoDataset.py:137-158), see data/disk_cache.py."""
        from .disk_cache import build_disk_cache

        self._disk_cache = build_disk_cache(self, cache_dir, workers=workers,
                                            force=force)

    def preload_cache(self, workers: int = 4) -> None:
        """Eagerly decode every image into the RAM cache with a thread pool
        (reference cocoDataset.py:137-158 ThreadPool preload; threads overlap
        file IO even on the 1-core host). Lazy caching still happens on
        first access if this is never called."""
        if not self.cache:
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(self.load_image, range(len(self))))

    def __len__(self):
        return len(self.ids)

    def decode_image(self, index: int) -> np.ndarray:
        """Raw decode + letterbox, bypassing every cache layer."""
        with Image.open(self._img_path(index)) as im:
            img, _ = letterbox_image(im, self.img_size)
        return img

    def load_batch(self, idxs) -> dict | None:
        """Vectorized collate, available once the disk cache is attached:
        images come out of the memmap via ONE fancy-index gather (a C-level
        page-cache copy) instead of 128 per-image Python decode/stack steps —
        the difference between ~160 and >1500 img/s on the 1-core host.
        Returns the same dict as loader._collate, or None (no cache)."""
        if self._disk_cache is None:
            return None
        idxs = np.asarray(idxs, np.int64)
        imgs = self._disk_cache.gather(idxs)
        labels = np.stack([self.labels_for(int(i)) for i in idxs])
        hs = np.asarray([self.annotations[i][2] for i in idxs], np.int32)
        ws = np.asarray([self.annotations[i][3] for i in idxs], np.int32)
        ids = np.asarray([self.annotations[i][4] for i in idxs], np.int64)
        return {"images": imgs, "labels": labels, "img_h": hs, "img_w": ws,
                "img_id": ids}

    def load_image(self, index: int) -> np.ndarray:
        if self._disk_cache is not None:
            return self._disk_cache[index]
        if self.cache and index in self._cache_store:
            return self._cache_store[index]
        img = self.decode_image(index)
        if self.cache:
            self._cache_store[index] = img
        return img

    def labels_for(self, index: int) -> np.ndarray:
        """[max_labels, 5] = [cls, cx, cy, w, h] in letterboxed pixels."""
        boxes, classes, _, _, _ = self.annotations[index]
        out = np.zeros((self.max_labels, 5), np.float32)
        n = min(len(boxes), self.max_labels)
        if n:
            b = boxes[:n]
            out[:n, 0] = classes[:n]
            out[:n, 1] = (b[:, 0] + b[:, 2]) / 2
            out[:n, 2] = (b[:, 1] + b[:, 3]) / 2
            out[:n, 3] = b[:, 2] - b[:, 0]
            out[:n, 4] = b[:, 3] - b[:, 1]
        return out

    def __getitem__(self, index: int):
        img = self.load_image(index)
        labels = self.labels_for(index)
        _, _, h, w, img_id = self.annotations[index]
        return img, labels, (h, w), img_id

    def gt_per_class(self, num_classes: int):
        """Per-class GT boxes in ORIGINAL image coords for the VOC evaluator
        (reference cocoDataset.py:160-174)."""
        out = [[np.empty((0, 4), np.float32) for _ in range(num_classes)]
               for _ in range(len(self))]
        for i, (boxes, classes, h, w, _) in enumerate(self.annotations):
            r = min(self.img_size[0] / h, self.img_size[1] / w)
            for c in range(num_classes):
                sel = classes == c
                if sel.any():
                    out[i][c] = boxes[sel] / r
        return out


class COCODataset(DetectionDataset):
    """COCO-format detection dataset (reference cocoDataset.py:9-174)."""

    def __init__(self, data_dir: str, json_file: str, img_dir: str,
                 img_size=(640, 640), max_labels: int = 100, cache: bool = False):
        super().__init__(img_size, max_labels, cache)
        self.data_dir = Path(data_dir)
        self.img_dir = self.data_dir / img_dir
        with open(self.data_dir / json_file) as f:
            coco = json.load(f)
        cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
        self.class_ids = [c["id"] for c in cats]          # dataset cat id per class idx
        self.class_names = [c.get("name", str(c["id"])) for c in cats]
        cat_to_idx = {cid: i for i, cid in enumerate(self.class_ids)}

        imgs = {im["id"]: im for im in coco["images"]}
        anns_by_img: dict[int, list] = {im_id: [] for im_id in imgs}
        # Raw annotations INCLUDING iscrowd, in original-image coords, for the
        # evaluator: the reference evaluates against the full GT json where
        # crowd anns act as ignore regions (cocoeval.py:115,192-193); only the
        # *training* labels drop crowds below.
        self.eval_annotations = [
            {"image_id": a["image_id"], "category_id": a["category_id"],
             "bbox": list(a["bbox"]),
             "area": a.get("area", a["bbox"][2] * a["bbox"][3]),
             "iscrowd": int(a.get("iscrowd", 0))}
            for a in coco.get("annotations", [])
            if a["image_id"] in anns_by_img
        ]
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            if a["image_id"] in anns_by_img:
                anns_by_img[a["image_id"]].append(a)

        self.ids = sorted(imgs.keys())
        self._files = {}
        self.annotations = []
        for img_id in self.ids:
            im = imgs[img_id]
            h, w = im["height"], im["width"]
            r = min(self.img_size[0] / h, self.img_size[1] / w)
            boxes, classes = [], []
            for a in anns_by_img[img_id]:
                x, y, bw, bh = a["bbox"]
                # clip to image, drop degenerate (cocoDataset.py obj filtering)
                x1 = max(x, 0.0)
                y1 = max(y, 0.0)
                x2 = min(x + bw, w)
                y2 = min(y + bh, h)
                if a.get("area", bw * bh) > 0 and x2 > x1 and y2 > y1:
                    boxes.append([x1 * r, y1 * r, x2 * r, y2 * r])
                    classes.append(cat_to_idx[a["category_id"]])
            self.annotations.append((
                np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(classes, np.int32),
                h, w, img_id,
            ))
            self._files[img_id] = im["file_name"]

    def _img_path(self, index: int) -> str:
        return str(self.img_dir / self._files[self.ids[index]])


VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class VOCDataset(DetectionDataset):
    """Pascal-VOC detection dataset (reference vocDataset.py:8-173):
    ImageSets txt split + per-image XML annotations."""

    def __init__(self, data_dir: str, split_file: str,
                 img_dir: str = "JPEGImages", ann_dir: str = "Annotations",
                 img_size=(640, 640), max_labels: int = 100,
                 class_names=VOC_CLASSES, keep_difficult: bool = False,
                 cache: bool = False):
        super().__init__(img_size, max_labels, cache)
        self.data_dir = Path(data_dir)
        self.img_dir = self.data_dir / img_dir
        self.class_names = list(class_names)
        self.class_ids = list(range(len(self.class_names)))
        name_to_idx = {n: i for i, n in enumerate(self.class_names)}

        with open(self.data_dir / split_file) as f:
            stems = [line.strip().split()[0] for line in f if line.strip()]
        self.ids = list(range(len(stems)))
        self._stems = stems
        self.annotations = []
        for i, stem in enumerate(stems):
            tree = ET.parse(self.data_dir / ann_dir / f"{stem}.xml")
            size = tree.find("size")
            h = int(size.find("height").text)
            w = int(size.find("width").text)
            r = min(self.img_size[0] / h, self.img_size[1] / w)
            boxes, classes = [], []
            for obj in tree.iter("object"):
                difficult = obj.find("difficult")
                if (not keep_difficult and difficult is not None
                        and int(difficult.text) == 1):
                    continue
                name = obj.find("name").text.strip().lower()
                if name not in name_to_idx:
                    continue
                bb = obj.find("bndbox")
                # VOC pixel indices are 1-based (vocDataset.py convention)
                x1 = float(bb.find("xmin").text) - 1
                y1 = float(bb.find("ymin").text) - 1
                x2 = float(bb.find("xmax").text) - 1
                y2 = float(bb.find("ymax").text) - 1
                boxes.append([x1 * r, y1 * r, x2 * r, y2 * r])
                classes.append(name_to_idx[name])
            self.annotations.append((
                np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(classes, np.int32),
                h, w, i,
            ))

    def _img_path(self, index: int) -> str:
        return str(self.img_dir / f"{self._stems[index]}.jpg")
