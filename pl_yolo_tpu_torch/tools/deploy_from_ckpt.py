"""A trained port checkpoint through every exporter, each artifact held
against the port's eager forward of the restored model:

    checkpoint --> npz --> numpy runtime            (deploy.numpy_infer)
               --> ONNX --> numpy ONNX runtime       (deploy.export_onnx)
               --> TorchScript (.pt), on the device  (deploy.export)

the JAX package's chain (its `tools/deploy_from_ckpt.py`). The
checkpoint's best step by mAP (else its latest) is restored, EMA weights
and BN statistics. The artifacts are fp32 and held against the fp32 eager
forward on one random image (max |a - b| over [1,A,5+C]); with a config
dtype other than fp32, that dtype's eager forward's distance to the fp32
one is printed too. Prints one JSON line; exits 1 if any artifact is
further than --tol. The served program (`.pt2`, with the NMS) of a
checkpoint is held to its eager function by `tools.export --ckpt
--verify`.

    python -m pl_yolo_tpu_torch.tools.deploy_from_ckpt -c <model.yaml> \\
        --checkpoint <run>/checkpoints --num-classes 6 --size 160 \\
        [--out-dir DIR] [--tol 5e-3] [--device cpu]

It runs on the CUDA card unless --device cpu (or --cpu); without a card
it refuses to start.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--num-classes", type=int, required=True)
    ap.add_argument("--size", type=int, default=160)
    ap.add_argument("--out-dir", default=None,
                    help="where the artifacts go (default: a new "
                         "temporary directory)")
    ap.add_argument("--tol", type=float, default=5e-3,
                    help="max-abs parity tolerance (trained weights give "
                         "larger activations than random init)")
    ap.add_argument("--device", default=None,
                    help="default the CUDA card; 'cpu' runs on the host")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args(argv)

    import torch

    from pl_yolo_tpu_torch.deploy import export
    from pl_yolo_tpu_torch.deploy import numpy_infer as ni
    from pl_yolo_tpu_torch.deploy.onnx_numpy_runtime import OnnxModel
    from pl_yolo_tpu_torch.train.checkpoint import CheckpointManager
    from pl_yolo_tpu_torch.tools import deploy_cli as cli
    from pl_yolo_tpu_torch.utils.config import load_config

    device = cli.device_or_exit("cpu" if args.cpu else args.device)
    out = pathlib.Path(args.out_dir or tempfile.mkdtemp(
        prefix="deploy_from_ckpt_"))
    out.mkdir(parents=True, exist_ok=True)
    best = CheckpointManager(args.checkpoint).best_step
    model, step = export.load_model(args.config, args.num_classes, device,
                                    args.checkpoint, step=best)
    print(f"restored checkpoint step {step} (EMA weights + BN stats)")

    img = cli.random_images(args.size, seed=5)
    want = cli.eager_predictions(model, img)
    finite = np.isfinite(want)  # a trained decode may overflow
    results = {"ckpt_step": step,
               "oracle_scale": round(float(np.abs(want[finite]).max(
                   initial=0.0)), 2),
               "oracle_nonfinite": int((~finite).sum())}

    dtype = load_config(args.config).get("dtype")
    if dtype and dtype not in ("float32", "fp32"):  # informational
        train = export.load_model(args.config, args.num_classes, device,
                                  args.checkpoint, step=best, fp32=False)[0]
        results[f"device_{dtype}_vs_fp32_diff"] = export.max_abs_err(
            cli.eager_predictions(train, img), want)

    # npz + numpy runtime
    npz = out / "model.npz"
    export.export_npz(model.cfg, model, npz)
    params, stats, meta = ni.load_npz(npz)
    host = ni.forward(params, stats, img, meta)
    results["npz_numpy_max_abs"] = export.max_abs_err(host, want)

    # ONNX file + numpy ONNX runtime
    blob = export.export_onnx(model, batch=1, size=args.size)
    (out / "model.onnx").write_bytes(blob)
    got = OnnxModel(blob).run({"images": cli.nchw(img)})["predictions"]
    results["onnx_numpy_max_abs"] = export.max_abs_err(got, want)

    # TorchScript through the .pt file, on the device
    pt = out / "model.pt"
    export.export_torchscript(model, pt, size=args.size, batch=1)
    ts = torch.jit.load(str(pt), map_location=device)
    with torch.no_grad():
        got = ts(torch.from_numpy(cli.nchw(img)).to(device)).cpu().numpy()
    results["torchscript_max_abs"] = export.max_abs_err(got, want)

    parities = [v for k, v in results.items() if k.endswith("_max_abs")]
    results["tol"] = args.tol
    results["pass"] = bool(all(p <= args.tol for p in parities))
    print(json.dumps(results))
    return 0 if results["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
