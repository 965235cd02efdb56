"""Export a YOLOX-, YOLOv7- or YOLOv5-family model of the port to ONNX:
torch's symbolic tracer on the fp32 folded eval forward and decode
(`deploy.export.export_onnx`), written without the `onnx` package. A
standard opset-13, IR-8 graph: `images` [B,3,S,S] 0-255 in, `predictions`
[B,A,5+C] out (xyxy, sigmoid obj and cls); NMS is left to the consumer.

    python -m pl_yolo_tpu_torch.tools.export_onnx -c <model.yaml> \\
        [--checkpoint <run>/checkpoints] --out model.onnx \\
        [--batch 1] [--size 640] [--verify] [--device cpu]

The graph is traced on the host. --verify executes the written file with
the port's numpy ONNX runtime and holds it against the port's eager fp32
eval forward on the device (the CUDA card unless --device cpu; without a
card the tool refuses to start; bound `tools.deploy_cli.verify_tol`).
Consume it with any ONNX runtime, or `python -m
pl_yolo_tpu_torch.tools.onnx_demo model.onnx image.jpg`.
"""

from __future__ import annotations

import argparse
import pathlib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="port checkpoint dir; EMA weights are exported")
    ap.add_argument("--out", default="model.onnx")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--verify", action="store_true",
                    help="execute the written file (numpy ONNX runtime) "
                         "against the eager forward")
    ap.add_argument("--device", default=None,
                    help="default the CUDA card; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    from pl_yolo_tpu_torch.deploy import export
    from pl_yolo_tpu_torch.tools import deploy_cli as cli

    device = cli.device_or_exit(args.device)
    model, _ = export.load_model(args.config, args.num_classes, device,
                                 args.checkpoint)
    blob = export.export_onnx(model, batch=args.batch, size=args.size)
    pathlib.Path(args.out).write_bytes(blob)
    print(f"wrote {args.out}: {len(blob) / 2**20:.2f} MiB, opset 13, "
          f"input [{args.batch},3,{args.size},{args.size}]")

    if args.verify:
        from pl_yolo_tpu_torch.deploy import numpy_infer as ni
        from pl_yolo_tpu_torch.deploy.onnx_numpy_runtime import OnnxModel

        img = cli.random_images(args.size, args.batch)
        want = cli.eager_predictions(model, img)
        got = OnnxModel(pathlib.Path(args.out).read_bytes()).run(
            {"images": cli.nchw(img)})["predictions"]
        tol = cli.verify_tol(device)
        err = export.max_abs_err(got, want, relative=True)
        print(f"max rel err eager-vs-onnx-file: {err:.3e} (tol {tol})")
        if not err <= tol:
            print("ONNX artifact parity FAILED")
            return 1
        dets = ni.postprocess(got, conf_threshold=0.3)
        print(f"onnx postprocess: {[d.shape[0] for d in dets]} detections")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
