"""Profiling and tracing (port of `pl_yolo_tpu/utils/profiler.py`).

    with trace("./profile"):            # a Chrome / Perfetto trace file
        for _ in range(3):
            with annotate("train_step"):
                step(state, images, labels)

`trace` runs `torch.profiler` over the CPU and, where there is one, the
CUDA card, and writes `<log_dir>/trace.json` (open it in Perfetto or
chrome://tracing); `StepTimer` times steps on the host clock, fenced so that
the device's queue has drained; `annotate` names a region of the trace.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str = "./profile"):
    """Profile the block on the CPU and, if CUDA is available, the card;
    on exit write `<log_dir>/trace.json`. Yields the `torch.profiler.profile`
    object, whose `key_averages()` sums the time by op and kernel."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Host-clock step times. Calls return before the card has run them, so
    `stop` fences first: a scalar read-back of `sync_value` (a tensor the
    step produced) when given, else `torch.cuda.synchronize()` where CUDA
    is in use. `mean` drops the first time (warm-up: kernel builds, cuDNN's
    algorithm search, allocator growth), as the JAX version drops its
    compile."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value: torch.Tensor | None = None) -> float:
        if sync_value is not None:
            float(sync_value.detach().float().sum())  # fence
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        xs = self.times[1:] if len(self.times) > 1 else self.times
        return sum(xs) / max(len(xs), 1)


def annotate(name: str):
    """A named region of the trace (`torch.profiler.record_function`)."""
    return record_function(name)
