"""Detect objects in one image with an exported program (`.pt2`, from
`tools.export`) or a live model, and draw them.

The image is letterboxed to the model's size (`data.datasets.
letterbox_image`), run through the served function (forward, decode and
NMS; in a `.pt2` all three are baked in, the NMS kernel included), and the
valid boxes are scaled back to the image and drawn
(`utils.visualize.draw_detections`).

    python -m pl_yolo_tpu_torch.tools.inference_demo --image img.jpg \\
        [--export model.pt2 | -c model.yaml [--ckpt <run>/checkpoints]] \\
        [--size 640] [--num-classes 80] [--conf 0.25] [--nms 0.5] \\
        [-o detections.jpg] [--device cpu]

With --export, --size must be the size the program was exported at, and
its own thresholds apply. It runs on the CUDA card unless --device cpu;
without a card it refuses to start.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser("inference demo")
    p.add_argument("--image", required=True)
    p.add_argument("--export", default=None, help="exported program (.pt2)")
    p.add_argument("-c", "--model_config", default=None)
    p.add_argument("--ckpt", default=None, help="port checkpoint dir")
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--nms", type=float, default=0.5)
    p.add_argument("-o", "--output", default="detections.jpg")
    p.add_argument("--device", default=None,
                   help="default the CUDA card; 'cpu' runs on the host")
    args = p.parse_args(argv)
    if not (args.export or args.model_config):
        raise SystemExit("provide --export or -c <model.yaml>")

    import torch
    from PIL import Image

    from pl_yolo_tpu_torch.data.datasets import letterbox_image
    from pl_yolo_tpu_torch.deploy import export
    from pl_yolo_tpu_torch.tools import deploy_cli as cli
    from pl_yolo_tpu_torch.utils.visualize import draw_detections

    device = cli.device_or_exit(args.device)
    with Image.open(args.image) as im:
        im = im.convert("RGB")
        orig = np.asarray(im)
        canvas, ratio = letterbox_image(im, (args.size, args.size))
    x = torch.from_numpy(canvas[None].astype(np.float32)).to(device)

    if args.export:
        serve = export.load_program(args.export, device)
    else:
        model, _ = export.load_model(args.model_config, args.num_classes,
                                     device, args.ckpt, fp32=False)
        serve = export.ServeModule(model.module, model.loss.eval_decode,
                                   args.conf, args.nms)
    with torch.no_grad():
        boxes, scores, classes, valid = (t[0].cpu() for t in serve(x))
    boxes = boxes[valid].float().numpy() / ratio
    scores = scores[valid].float().numpy()
    classes = classes[valid].numpy()
    print(f"{len(boxes)} detections")
    drawn = draw_detections(orig, boxes, scores, classes, score_thr=0.0)
    Image.fromarray(drawn).save(args.output)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
