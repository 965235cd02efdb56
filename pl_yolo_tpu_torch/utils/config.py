"""YAML model-config loading with light schema validation.

The port's own model YAMLs live in `pl_yolo_tpu_torch/configs/model/`
(`CONFIG_DIR`): copies of the JAX package's YOLOX-family files, which a test
holds equal to their originals.
"""

from __future__ import annotations

from pathlib import Path

import yaml

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def load_config(path: str | Path) -> dict:
    """ASCII-safe YAML load."""
    with open(path, "r", encoding="ascii", errors="ignore") as f:
        return yaml.safe_load(f)


REQUIRED_MODEL_KEYS = ("backbone", "neck", "head", "loss", "optimizer")


def validate_model_config(cfg: dict, path: str = "<model cfg>") -> dict:
    missing = [k for k in REQUIRED_MODEL_KEYS if k not in cfg]
    if missing:
        raise ValueError(f"{path}: missing model-config sections: {missing}")
    return cfg
