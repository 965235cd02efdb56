"""Export a YOLOX-, YOLOv7- or YOLOv5-family model of the port to the npz
artifact (flat fp32 weights and a JSON meta record) that
`pl_yolo_tpu_torch.deploy.numpy_infer` runs with numpy alone.

    python -m pl_yolo_tpu_torch.tools.export_npz -c <model.yaml> \\
        [--checkpoint <run>/checkpoints] --out model.npz [--verify] \\
        [--size 256] [--num-classes 80] [--device cpu]

Without --checkpoint the seeded init is exported (a valid parity check,
meaningless detections); with it, the EMA weights of the latest step of a
port checkpoint. --verify runs the written file through the numpy runtime
on a random image and holds it against the port's eager fp32 eval forward
(`tools.deploy_cli.verify_tol`). The model runs on the CUDA card unless
--device cpu; without a card the tool refuses to start.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="port checkpoint dir; EMA weights are exported")
    ap.add_argument("--out", default="model.npz")
    ap.add_argument("--num-classes", type=int, default=80)
    ap.add_argument("--verify", action="store_true",
                    help="run the numpy runtime against the eager forward")
    ap.add_argument("--size", type=int, default=256,
                    help="verify image size (multiple of 64)")
    ap.add_argument("--device", default=None,
                    help="default the CUDA card; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    from pl_yolo_tpu_torch.deploy import export
    from pl_yolo_tpu_torch.tools import deploy_cli as cli

    device = cli.device_or_exit(args.device)
    model, _ = export.load_model(args.config, args.num_classes, device,
                                 args.checkpoint)
    meta = export.export_npz(model.cfg, model, args.out)
    n = sum(p.numel() for p in model.module.parameters())
    print(f"wrote {args.out}: {n / 1e6:.2f}M params, meta={meta}")

    if args.verify:
        from pl_yolo_tpu_torch.deploy import numpy_infer as ni

        img = cli.random_images(args.size)
        want = cli.eager_predictions(model, img)
        params, stats, meta = ni.load_npz(args.out)
        host = ni.forward(params, stats, img, meta)
        tol = cli.verify_tol(device)
        err = export.max_abs_err(host, want, relative=True)
        print(f"max rel err eager-vs-numpy: {err:.3e} (tol {tol})")
        if not err <= tol:
            print("numpy deploy parity FAILED")
            return 1
        dets = ni.postprocess(host, conf_threshold=0.3)
        print(f"numpy postprocess: {[d.shape[0] for d in dets]} detections")
        print("parity OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
