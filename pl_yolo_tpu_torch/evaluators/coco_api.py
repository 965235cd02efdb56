"""COCO annotation API.

Capability parity with the reference's vendored pycocotools COCO class
(models/data/datasets/pycocotools/coco.py:73-456): dataset indexing,
getAnnIds / getCatIds / getImgIds / loadAnns / loadCats / loadImgs,
loadRes (:323) for detection-result lists, annToRLE / annToMask via the
native RLE ops, plus the reference's custom getCatNames (coco.py:176-193).
"""

from __future__ import annotations

import copy
import itertools
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

from . import mask_ops


class COCO:
    def __init__(self, annotation_file: str | dict | None = None):
        self.dataset: dict = {}
        self.anns: dict = {}
        self.cats: dict = {}
        self.imgs: dict = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            assert isinstance(self.dataset, dict), "annotation file must hold a dict"
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns = defaultdict(list)
        catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            catToImgs[ann["category_id"]].append(ann["image_id"])
        self.anns, self.cats, self.imgs = anns, cats, imgs
        self.imgToAnns, self.catToImgs = imgToAnns, catToImgs

    # --------------------------------------------------------------- gets

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(), iscrowd=None):
        imgIds = [imgIds] if np.isscalar(imgIds) else list(imgIds)
        catIds = [catIds] if np.isscalar(catIds) else list(catIds)
        if imgIds:
            anns = list(itertools.chain.from_iterable(
                self.imgToAnns[i] for i in imgIds if i in self.imgToAnns))
        else:
            anns = self.dataset.get("annotations", [])
        if catIds:
            anns = [a for a in anns if a["category_id"] in catIds]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a.get("area", 0) < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=(), supNms=(), catIds=()):
        cats = self.dataset.get("categories", [])
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getCatNames(self, catIds=()):
        """Reference custom helper (coco.py:176-193): names for cat ids,
        in the given order."""
        catIds = [catIds] if np.isscalar(catIds) else list(catIds)
        if not catIds:
            catIds = sorted(self.cats.keys())
        return [self.cats[i]["name"] for i in catIds]

    def getImgIds(self, imgIds=(), catIds=()):
        imgIds = [imgIds] if np.isscalar(imgIds) else list(imgIds)
        catIds = [catIds] if np.isscalar(catIds) else list(catIds)
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        for i, cat in enumerate(catIds):
            cat_imgs = set(self.catToImgs[cat])
            ids = cat_imgs if (i == 0 and not imgIds) else ids & cat_imgs
        return sorted(ids)

    def loadAnns(self, ids=()):
        ids = [ids] if np.isscalar(ids) else list(ids)
        return [self.anns[i] for i in ids]

    def loadCats(self, ids=()):
        ids = [ids] if np.isscalar(ids) else list(ids)
        return [self.cats[i] for i in ids]

    def loadImgs(self, ids=()):
        ids = [ids] if np.isscalar(ids) else list(ids)
        return [self.imgs[i] for i in ids]

    # ------------------------------------------------------------ loadRes

    def loadRes(self, resFile) -> "COCO":
        """Load detection results (list of dicts, json path, or array) into a
        new COCO object sharing this one's images (coco.py:323-380)."""
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]
        if isinstance(resFile, (str, Path)):
            with open(resFile) as f:
                anns = json.load(f)
        elif isinstance(resFile, np.ndarray):
            anns = self.loadNumpyAnnotations(resFile)
        else:
            anns = resFile
        assert isinstance(anns, list), "results must be a list"
        if not anns:
            res.dataset["annotations"] = []
            res.createIndex()
            return res
        annsImgIds = [a["image_id"] for a in anns]
        assert set(annsImgIds) <= set(self.getImgIds()), \
            "results reference unknown image ids"
        anns = copy.deepcopy(anns)
        if "bbox" in anns[0] and anns[0]["bbox"] != []:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset.get("categories", []))
            for aid, ann in enumerate(anns):
                bb = ann["bbox"]
                if "segmentation" not in ann or not ann["segmentation"]:
                    ann["segmentation"] = [[bb[0], bb[1], bb[0], bb[1] + bb[3],
                                            bb[0] + bb[2], bb[1] + bb[3],
                                            bb[0] + bb[2], bb[1]]]
                ann["area"] = bb[2] * bb[3]
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
        elif "segmentation" in anns[0]:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset.get("categories", []))
            for aid, ann in enumerate(anns):
                ann["area"] = mask_ops.area(ann["segmentation"])
                ann["bbox"] = mask_ops.toBbox(ann["segmentation"]).tolist()
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    def loadNumpyAnnotations(self, data: np.ndarray) -> list[dict]:
        """[[imageID, x1, y1, w, h, score, class]] -> result dicts."""
        assert data.shape[1] == 7
        return [{
            "image_id": int(row[0]),
            "bbox": [row[1], row[2], row[3], row[4]],
            "score": row[5],
            "category_id": int(row[6]),
        } for row in data]

    # --------------------------------------------------------------- RLE

    def annToRLE(self, ann) -> dict:
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = mask_ops.frPyObjects(segm, h, w)
            if isinstance(rles, list):
                return mask_ops.merge(rles)
            return rles
        if isinstance(segm.get("counts"), list):
            return mask_ops.frPyObjects(segm, h, w)
        return segm

    def annToMask(self, ann) -> np.ndarray:
        return mask_ops.decode(self.annToRLE(ann))
