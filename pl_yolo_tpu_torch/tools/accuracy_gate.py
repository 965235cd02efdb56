"""The port's accuracy gate (the recipe of the JAX package's
`tools/accuracy_gate.py`):

    python -m pl_yolo_tpu_torch.tools.accuracy_gate --model yolox_tiny
    python -m pl_yolo_tpu_torch.tools.accuracy_gate --model yolov7_tiny --autoanchor
    python -m pl_yolo_tpu_torch.tools.accuracy_gate --model yolov5_s --autoanchor

trains a seeded model on a hard-shapes set it generates itself
(`make_shapes_dataset.make_split(..., hard=True)`: 400 train and 100 val
images at 160 px, seeds 10 and 11, so nothing is downloaded) through
`Trainer.fit`, and asserts the best held-out COCO mAP of its validations
against the floor calibrated for the JAX package. It appends one JSON line
to `GATE_RESULTS.jsonl` beside this file (the JAX gate's fields, plus the
device: the card's name and power limit) and exits 0 on a pass and 1 on a
fail. It runs on the CUDA card and refuses to start without one unless
`--device cpu` asks for the CPU (a dry run: `--epochs 1`).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import time

# (floor, default epochs) per model: the JAX package's calibration
# (its GATE_RESULTS.jsonl) less a margin; the anchor-based families
# converge ~2x slower than SimOTA on this set, so they run 200 epochs.
#   yolox_tiny : mAP 0.337 @100 epochs -> floor 0.25
#   yolov7_tiny: mAP 0.141 @200 epochs (autoanchor) -> floor 0.10
#   yolov5_s   : mAP 0.290 @200 epochs (autoanchor) -> floor 0.22
DEFAULT_FLOORS = {"yolox_tiny": (0.25, 100), "yolov7_tiny": (0.10, 200),
                  "yolov5_s": (0.22, 200)}
GATE_SIZE = 160
GATE_SEED = 10        # the data set's (train; val + 1)
TRAIN_SEED = 96       # the trainer's, as the JAX gate's
SHAPES_CLASSES = 6
RESULTS = pathlib.Path(__file__).resolve().with_name("GATE_RESULTS.jsonl")


def argument_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("python -m pl_yolo_tpu_torch.tools."
                                 "accuracy_gate")
    ap.add_argument("--epochs", type=int, default=None,
                    help="default: the model's calibrated recipe length "
                         "(100 for yolox_tiny, 200 for the anchor family)")
    ap.add_argument("--model", default="yolox_tiny",
                    choices=sorted(DEFAULT_FLOORS))
    ap.add_argument("--floor", type=float, default=None,
                    help="override the calibrated floor (0.0 = a "
                         "calibration run)")
    ap.add_argument("--balance", choices=["reference", "ultralytics"],
                    default=None,
                    help="yolov7 per-level obj balance: 'reference' "
                         "(0.4, 1, 4) or 'ultralytics' (4, 1, 0.4); "
                         "default: the config's")
    ap.add_argument("--scale-gains", action="store_true",
                    help="anchor-based models: the upstream train-time "
                         "loss-gain scaling (obj *= (size/640)^2, cls *= "
                         "nc/80); an experiment flag")
    ap.add_argument("--autoanchor", action="store_true",
                    help="k-means the anchor priors from the gate set's "
                         "boxes (anchor-based models only)")
    ap.add_argument("--root", default=os.path.expanduser(
        "~/.cache/pl_yolo_tpu_torch_gate/shapes_hard_160"))
    ap.add_argument("--out", default=None,
                    help="run directory, kept (default: a temporary one, "
                         "removed when the run ends)")
    ap.add_argument("--seed", type=int, default=TRAIN_SEED,
                    help="the trainer's seed (init, data order, "
                         "augmentation); the default is the JAX gate's, "
                         "another measures the spread between runs")
    ap.add_argument("--results", type=pathlib.Path, default=RESULTS,
                    help="the JSON-lines file the result is appended to")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card, which must "
                         "exist; 'cpu' runs on the CPU)")
    return ap


def ensure_dataset(root: pathlib.Path) -> None:
    if (root / "annotations" / "instances_val.json").exists():
        return
    from .make_shapes_dataset import make_split
    make_split(root, "train", 400, GATE_SIZE, GATE_SEED, hard=True)
    make_split(root, "val", 100, GATE_SIZE, GATE_SEED + 1, hard=True)


def build_configs(args) -> tuple[dict, dict]:
    """(model config, data config) of the gate: the model's YAML with the
    no-aug epochs scaled to the run, the balance, loss gains and anchors
    the flags ask for, and `shapes_hard.yaml` at 160 px on `args.root`.
    Raises ValueError on a flag that does not apply to the model."""
    from ..utils.config import (CONFIG_DIR, load_config,
                                validate_data_config, validate_model_config)
    model_cfg = validate_model_config(
        load_config(CONFIG_DIR / "model" / f"{args.model}.yaml"),
        f"{args.model}.yaml")
    # the upstream 300-epoch recipe's 15 no-aug epochs, scaled to the gate
    model_cfg.setdefault("schedule", {})
    model_cfg["schedule"]["no_aug_epochs"] = max(4, args.epochs // 5)
    loss = model_cfg["loss"]
    if args.balance:
        if loss["name"] != "yolov7":
            raise ValueError("--balance applies to the yolov7 loss")
        loss["balance"] = ([0.4, 1.0, 4.0] if args.balance == "reference"
                           else [4.0, 1.0, 0.4])
    if args.scale_gains:
        if "anchors" not in loss:
            raise ValueError(f"--scale-gains: {args.model} is anchor-free")
        loss["gain"] = {"obj": (GATE_SIZE / 640.0) ** 2,
                        "cls": 0.5 * SHAPES_CLASSES / 80.0}
    if args.autoanchor:
        if "anchors" not in loss:
            raise ValueError(f"--autoanchor: {args.model} is anchor-free")
        from ..utils.autoanchor import dataset_anchors
        anchors = dataset_anchors(
            str(pathlib.Path(args.root) / "annotations/instances_train.json"),
            n_levels=len(loss["anchors"]), per_level=len(loss["anchors"][0]),
            img_size=(GATE_SIZE, GATE_SIZE))
        loss["anchors"] = [list(map(list, lvl)) for lvl in anchors]

    data_cfg = validate_data_config(
        load_config(CONFIG_DIR / "data" / "shapes_hard.yaml"),
        "shapes_hard.yaml")
    data_cfg["dataset"]["dir"] = str(args.root)
    data_cfg["dataset"]["train_size"] = [GATE_SIZE, GATE_SIZE]
    data_cfg["dataset"]["val_size"] = [GATE_SIZE, GATE_SIZE]
    return model_cfg, data_cfg


def card_line() -> str | None:
    """`name, power limit` of the card as nvidia-smi gives them, or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def prepare(args):
    """Resolve the device, the epochs and the floor, write the data set if
    it is missing, and build the configs: returns (device, model config,
    data config). Raises RuntimeError where the card is asked for and there
    is none, and ValueError on a flag that does not apply to the model."""
    from .. import resolve_device
    device = resolve_device(args.device)
    floor, default_epochs = DEFAULT_FLOORS[args.model]
    if args.epochs is None:
        args.epochs = default_epochs
    if args.floor is None:
        env = os.environ.get("GATE_FLOOR")
        args.floor = float(env) if env is not None else floor
    ensure_dataset(pathlib.Path(args.root))
    model_cfg, data_cfg = build_configs(args)
    if args.autoanchor:
        print(f"autoanchor: {model_cfg['loss']['anchors']}")
    if args.scale_gains:
        print(f"scale-gains: {model_cfg['loss']['gain']}")
    return device, model_cfg, data_cfg


def run(args, device, model_cfg: dict, data_cfg: dict):
    """Train and evaluate the gate (after `prepare`); returns (result dict,
    trainer). The result is appended to `args.results`; the run directory
    (checkpoints, csv logs) is `args.out`, or a temporary one that is
    removed when the fit ends."""
    import contextlib
    import tempfile

    from ..train.trainer import Trainer

    t0 = time.time()
    with contextlib.ExitStack() as stack:
        out = args.out or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="accuracy_gate_"))
        trainer = Trainer(model_cfg, data_cfg, max_epochs=args.epochs,
                          check_val_every_n_epoch=max(5, args.epochs // 4),
                          output_dir=out,
                          experiment_name=f"gate_{args.model}",
                          logger="csv", seed=args.seed, device=device)
        trainer.fit()
    wall = time.time() - t0

    result = {
        "ts": time.time(), "model": args.model,
        "epochs": args.epochs, "size": GATE_SIZE,
        "mAP": round(trainer.best_map, 4),
        "mAP50": round(trainer.best_map50, 4),
        "floor": args.floor, "wall_s": round(wall, 1),
        "device": (card_line() or str(device)) if device.type == "cuda"
        else "cpu",
        "pass": trainer.best_map >= args.floor,
    }
    if args.autoanchor:
        result["autoanchor"] = True
    if args.scale_gains:
        result["scale_gains"] = True
    if args.balance:
        result["balance"] = args.balance
    if args.seed != TRAIN_SEED:
        result["seed"] = args.seed
    with open(args.results, "a") as f:
        f.write(json.dumps(result) + "\n")
    verdict = "PASS" if result["pass"] else "FAIL"
    print(f"accuracy_gate: {verdict} — held-out mAP {result['mAP']:.3f} "
          f"(mAP50 {result['mAP50']:.3f}) vs floor {args.floor:.2f} "
          f"in {wall:.0f}s / {args.epochs} epochs on {result['device']}",
          flush=True)
    return result, trainer


def main(argv=None):
    ap = argument_parser()
    args = ap.parse_args(argv)
    try:
        device, model_cfg, data_cfg = prepare(args)
    except RuntimeError as e:
        raise SystemExit(f"error: {e} (--device cpu)")
    except ValueError as e:
        ap.error(str(e))
    result, _ = run(args, device, model_cfg, data_cfg)
    raise SystemExit(0 if result["pass"] else 1)


if __name__ == "__main__":
    main()
