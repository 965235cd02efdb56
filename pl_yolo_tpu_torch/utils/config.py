"""YAML config loading with light schema validation, and the CLI's
argument parser (port of `pl_yolo_tpu/utils/config.py`).

The port's own YAMLs live in `pl_yolo_tpu_torch/configs/` (`CONFIG_DIR`):
`model/` holds copies of the JAX package's YOLOX-family files and `data/`
copies of its data files, which a test holds equal to their originals.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import yaml

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def load_config(path: str | Path) -> dict:
    """ASCII-safe YAML load."""
    with open(path, "r", encoding="ascii", errors="ignore") as f:
        return yaml.safe_load(f)


REQUIRED_MODEL_KEYS = ("backbone", "neck", "head", "loss", "optimizer")
REQUIRED_DATA_KEYS = ("datamodule", "dataset", "transform", "num_classes", "classes")


def validate_model_config(cfg: dict, path: str = "<model cfg>") -> dict:
    missing = [k for k in REQUIRED_MODEL_KEYS if k not in cfg]
    if missing:
        raise ValueError(f"{path}: missing model-config sections: {missing}")
    return cfg


def validate_data_config(cfg: dict, path: str = "<data cfg>") -> dict:
    missing = [k for k in REQUIRED_DATA_KEYS if k not in cfg]
    if missing:
        raise ValueError(f"{path}: missing data-config sections: {missing}")
    if len(cfg["classes"]) != cfg["num_classes"]:
        raise ValueError(
            f"{path}: num_classes={cfg['num_classes']} but {len(cfg['classes'])} class names")
    return cfg


def train_argument_parser() -> argparse.ArgumentParser:
    """The CLI's flags: the JAX `train.py`'s, plus `--device`."""
    p = argparse.ArgumentParser("python -m pl_yolo_tpu_torch")
    p.add_argument("-n", "--experiment_name", type=str, default=None)
    p.add_argument("-c", "--model_config", type=str, required=True,
                   help="path to the model yaml")
    p.add_argument("-d", "--dataset_config", type=str, required=True,
                   help="path to the data yaml")
    p.add_argument("-l", "--logger", type=str, default="tb",
                   help="logger backend: csv | tb | wandb | neptune")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint directory to load weights from")
    p.add_argument("--resume", action="store_true",
                   help="resume training (step, optimizer state, EMA) from "
                        "--ckpt, or from the run's own checkpoints")
    p.add_argument("--test", action="store_true", help="run test/eval only")
    p.add_argument("--visualize", action="store_true",
                   help="dump detection visualizations during test")
    p.add_argument("--nms", type=float, default=0.65, help="test NMS IoU threshold")
    p.add_argument("--conf", type=float, default=0.01, help="test confidence threshold")
    p.add_argument("--show_dir", type=str, default="./show",
                   help="directory for visualization dumps")
    p.add_argument("--show_score_thr", type=float, default=0.3,
                   help="min score for drawn boxes")
    p.add_argument("--data_path", type=str, default=None,
                   help="override dataset.dir from the data yaml")
    p.add_argument("--max_epochs", type=int, default=None,
                   help="override the 300-epoch default")
    p.add_argument("--output_dir", type=str, default="./runs")
    p.add_argument("--seed", type=int, default=96)
    p.add_argument("--sanitize", action="store_true",
                   help="log the gradient norm and the count of non-finite "
                        "gradient elements each epoch")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): the "
                        "backward pass names the op that made a NaN")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, which must "
                        "exist; 'cpu' runs on the CPU)")
    return p
