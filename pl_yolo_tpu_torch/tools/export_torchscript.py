"""Export a YOLOX-, YOLOv7- or YOLOv5-family model of the port to
TorchScript: the fp32 eval forward and decode with RepConvs fused and
BatchNorms folded (`deploy.export.DeployModule`), traced and
`torch.jit.save`d, so that a libtorch runtime loads it. Images [B,3,S,S]
0-255 in, predictions [B,A,5+C] out; NMS is left to the consumer.

    python -m pl_yolo_tpu_torch.tools.export_torchscript -c <model.yaml> \\
        [--checkpoint <run>/checkpoints] --out model.pt \\
        [--batch 1] [--size 640] [--verify] [--device cpu]

The trace is made on the device it will serve on (the CUDA card unless
--device cpu; without a card the tool refuses to start): a trace keeps
that device in its constants. --verify reloads the written file with
`torch.jit.load` and holds it against the port's eager fp32 eval forward
(`tools.deploy_cli.verify_tol`).
"""

from __future__ import annotations

import argparse
import pathlib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="port checkpoint dir; EMA weights are exported")
    ap.add_argument("--out", default="model.pt")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default the CUDA card; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    import torch

    from pl_yolo_tpu_torch.deploy import export
    from pl_yolo_tpu_torch.tools import deploy_cli as cli

    device = cli.device_or_exit(args.device)
    model, _ = export.load_model(args.config, args.num_classes, device,
                                 args.checkpoint)
    export.export_torchscript(model, args.out, size=args.size,
                              batch=args.batch)
    print(f"wrote {args.out} "
          f"({pathlib.Path(args.out).stat().st_size / 2**20:.2f} MiB, "
          f"input [{args.batch},3,{args.size},{args.size}], {device})")

    if args.verify:
        img = cli.random_images(args.size, args.batch)
        want = cli.eager_predictions(model, img)
        ts = torch.jit.load(args.out, map_location=device)
        with torch.no_grad():
            got = ts(torch.from_numpy(cli.nchw(img)).to(device)).cpu().numpy()
        tol = cli.verify_tol(device)
        err = export.max_abs_err(got, want, relative=True)
        print(f"max rel err eager-vs-torchscript-file: {err:.3e} (tol {tol})")
        if not err <= tol:
            print("TorchScript artifact parity FAILED")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
