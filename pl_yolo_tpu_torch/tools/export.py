"""Export the served function of a port model: `torch.export` of the eval
forward, decode and NMS (`postprocess`) at a fixed input shape, in the
config's own compute dtype, saved with `torch.export.save` (a `.pt2`).
Images [B,S,S,3] 0-255 in; (boxes, scores, classes, valid) out. The
suppression is the registered operator `pl_yolo_tpu_torch::nms_suppress`,
which on the card launches the hand-written NMS kernel: load the file with
`pl_yolo_tpu_torch.deploy.export.load_program`, which registers it and
moves the program to the card if it was exported elsewhere.

    python -m pl_yolo_tpu_torch.tools.export -c <model.yaml> \\
        [--ckpt <run>/checkpoints] -o model.pt2 [--size 640] \\
        [--num-classes 80] [--batch 1] [--conf 0.25] [--nms 0.5] \\
        [--verify] [--device cpu]

Any model the port builds. Without --ckpt the seeded init is exported;
with it, the EMA weights of the latest step of a port checkpoint. It runs
on the CUDA card unless --device cpu (without a card it refuses to
start). --verify loads the written file on the device and holds it
against the eager served function on random images: `valid` and
`classes` equal, boxes and scores to 1e-4 (1e-3 on the card) of their
scale.
"""

from __future__ import annotations

import argparse
import pathlib


def main(argv=None) -> int:
    p = argparse.ArgumentParser("export")
    p.add_argument("-c", "--model_config", required=True)
    p.add_argument("--ckpt", default=None, help="port checkpoint dir")
    p.add_argument("-o", "--output", default="model.pt2")
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--nms", type=float, default=0.5)
    p.add_argument("--verify", action="store_true")
    p.add_argument("--device", default=None,
                   help="default the CUDA card; 'cpu' runs on the host")
    args = p.parse_args(argv)

    import torch

    from pl_yolo_tpu_torch.deploy import export
    from pl_yolo_tpu_torch.tools import deploy_cli as cli

    device = cli.device_or_exit(args.device)
    model, _ = export.load_model(args.model_config, args.num_classes, device,
                                 args.ckpt, fp32=False)
    export.export_program(model, args.output, batch=args.batch,
                          size=args.size, conf=args.conf, nms=args.nms)
    n = pathlib.Path(args.output).stat().st_size
    print(f"wrote {args.output} ({n / 1e6:.2f} MB)")

    if args.verify:
        img = torch.from_numpy(cli.random_images(args.size, args.batch)
                               ).to(device)
        served = export.load_program(args.output, device)
        serve = export.ServeModule(model.module, model.loss.eval_decode,
                                   args.conf, args.nms)
        with torch.no_grad():
            got, want = served(img), serve(img)
        err = export.detections_err(got, want)
        tol = cli.verify_tol(device)
        print(f"served file vs eager: {err} (tol {tol})")
        if not err["same_valid"] or err["max_rel"] > tol:
            print("exported program parity FAILED")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
