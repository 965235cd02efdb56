"""Checkpointing: top-k-by-mAP retention and resume (port of
`pl_yolo_tpu/train/checkpoint.py`, which is Orbax's CheckpointManager).

One directory a step, `<directory>/<step>/`, holding `state.pt` (the tree,
by `torch.save`) and `metrics.json`. A save writes into a temporary
directory and renames it into place, so a step directory is whole or absent.
Retention follows Orbax's rules with `best_fn=metrics[monitor]`,
`best_mode="max"`:

- a save at a step no later than the latest kept one is skipped;
- once more than `max_to_keep` checkpoints exist, the `max_to_keep` best by
  the monitored metric stay (ties: the later step ranks higher) and the rest
  are deleted;
- `best_step` is the best kept step, `latest_step` the largest.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import torch

_STATE, _METRICS = "state.pt", "metrics.json"


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 2,
                 monitor: str = "mAP"):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        # {step: metrics}, in step order, of the checkpoints on disk
        self._metrics: dict[int, dict] = {}
        for path in sorted(self.directory.iterdir(),
                           key=lambda p: (len(p.name), p.name)):
            if path.name.isdigit() and (path / _STATE).is_file():
                metrics = {}
                if (path / _METRICS).is_file():
                    metrics = json.loads((path / _METRICS).read_text())
                self._metrics[int(path.name)] = metrics

    def _score(self, step: int) -> float:
        return float(self._metrics[step].get(self.monitor, 0.0))

    def save(self, step: int, state_tree: Any, metrics: dict | None = None
             ) -> bool:
        """state_tree: a dict of tensors, numbers and nested dicts/lists
        (what `torch.load(weights_only=True)` reads back). Returns False
        when the step is skipped."""
        step = int(step)
        latest = self.latest_step
        if latest is not None and latest >= step:
            return False
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        tmp = self.directory / f".{step}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state_tree, tmp / _STATE)
        (tmp / _METRICS).write_text(json.dumps(metrics))
        os.replace(tmp, self.directory / str(step))
        self._metrics[step] = metrics
        self._remove_old()
        return True

    def _remove_old(self):
        if len(self._metrics) <= self.max_to_keep:
            return
        ranked = sorted(self._metrics, key=self._score)  # stable: step order
        for step in ranked[:len(ranked) - self.max_to_keep]:
            shutil.rmtree(self.directory / str(step))
            del self._metrics[step]

    def wait(self):
        """Saves are synchronous; kept for the interface."""

    @property
    def best_step(self) -> int | None:
        if not self._metrics:
            return None
        return sorted(self._metrics, key=self._score)[-1]

    @property
    def latest_step(self) -> int | None:
        return max(self._metrics, default=None)

    def metrics(self, step: int) -> dict:
        """The metrics saved with `step`."""
        return dict(self._metrics[step])

    def restore(self, step: int | None = None, map_location="cpu") -> Any:
        step = step if step is not None else self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.directory / str(int(step)) / _STATE,
                          map_location=map_location, weights_only=True)

    def close(self):
        """Nothing stays open; kept for the interface."""
