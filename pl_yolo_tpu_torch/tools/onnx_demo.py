"""ONNX inference demo: run one image through a `.onnx` from
`tools.export_onnx` with the port's pure-numpy ONNX runtime, then numpy
NMS, and print (or write) the detections. A host tool: the graph runs in
numpy, on no card; any ONNX runtime can take the runtime's place, as the
file is a standard opset-13 graph.

    python -m pl_yolo_tpu_torch.tools.onnx_demo model.onnx image.jpg \\
        [--conf 0.3] [--nms 0.65] [--out detections.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from ..deploy import onnx_writer as ow
from ..deploy.numpy_infer import postprocess
from ..deploy.onnx_numpy_runtime import OnnxModel


def letterbox(img: np.ndarray, size: int):
    """Aspect-preserving resize and 114-pad to size x size, top-left, as
    the model was trained; returns (NCHW float32 input, scale ratio)."""
    from PIL import Image

    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    resized = np.asarray(Image.fromarray(img).resize((nw, nh)), np.uint8)
    canvas = np.full((size, size, 3), 114, np.uint8)
    canvas[:nh, :nw] = resized
    return canvas[None].astype(np.float32).transpose(0, 3, 1, 2), r


def input_size(model_bytes: bytes) -> int:
    """The spatial size of the graph's declared input [B,3,S,S]."""
    gp = ow.parse_message(ow.parse_message(model_bytes)[7][0])
    vi = ow.parse_message(gp[11][0])
    tt = ow.parse_message(ow.parse_message(vi[2][0])[1][0])
    dims = [ow.parse_message(d)[1][0] for d in ow.parse_message(tt[2][0])[1]]
    return int(dims[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("model")
    ap.add_argument("image")
    ap.add_argument("--conf", type=float, default=0.3)
    ap.add_argument("--nms", type=float, default=0.65)
    ap.add_argument("--out", default=None, help="write detections JSON")
    args = ap.parse_args(argv)

    from PIL import Image

    blob = pathlib.Path(args.model).read_bytes()
    img = np.asarray(Image.open(args.image).convert("RGB"))
    inp, ratio = letterbox(img, input_size(blob))
    preds = OnnxModel(blob).run({"images": inp})["predictions"]
    dets = postprocess(preds, conf_threshold=args.conf,
                       iou_threshold=args.nms)[0]
    dets[:, :4] /= ratio  # back to the original image
    print(f"{dets.shape[0]} detections (conf>={args.conf}):")
    for x1, y1, x2, y2, score, cls in dets:
        print(f"  class {int(cls):3d} score {score:.3f} "
              f"box [{x1:.1f}, {y1:.1f}, {x2:.1f}, {y2:.1f}]")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"bbox": [float(v) for v in d[:4]],
                        "score": float(d[4]), "category": int(d[5])}
                       for d in dets], f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
