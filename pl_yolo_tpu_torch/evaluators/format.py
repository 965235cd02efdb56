"""Detection output formatting (reference postprocess.py format_outputs,
:95-138): fixed-shape device Detections -> COCO-json dicts + per-class VOC
arrays with letterbox unscaling."""

from __future__ import annotations

import numpy as np

from ..ops.nms import Detections


def format_outputs(det: Detections, ids, hs, ws, val_size, class_ids,
                   num_classes: int, count: int | None = None):
    """det: batched Detections (device or host). ids/hs/ws: per-image id and
    original size. Returns (json_list, det_list[img][cls] = [N,5])."""
    boxes = det.boxes.cpu().numpy()
    scores = det.scores.cpu().numpy()
    classes = det.classes.cpu().numpy()
    valid = det.valid.cpu().numpy()
    b = boxes.shape[0] if count is None else count

    json_list = []
    det_list = [[np.empty((0, 5), np.float32) for _ in range(num_classes)]
                for _ in range(b)]
    for i in range(b):
        scale = min(val_size[0] / float(hs[i]), val_size[1] / float(ws[i]))
        v = valid[i]
        if not v.any():
            continue
        bx = boxes[i][v] / scale             # unscale (postprocess.py:110-111)
        sc = scores[i][v]
        cl = classes[i][v]
        for bb, s, c in zip(bx, sc, cl):
            json_list.append({
                "image_id": int(ids[i]),
                "category_id": int(class_ids[int(c)]),
                "bbox": [float(bb[0]), float(bb[1]),
                         float(bb[2] - bb[0]), float(bb[3] - bb[1])],
                "score": float(s),
                "segmentation": [],
            })
        for c in range(num_classes):
            sel = cl == c
            if sel.any():
                det_list[i][c] = np.concatenate(
                    [bx[sel], sc[sel, None]], axis=1).astype(np.float32)
    return json_list, det_list
