"""Profiling hooks, the twin of pix2pixhdaudiosr_tpu/utils/profiling.py.

* `trace(log_dir)`: a context manager around torch.profiler (CPU and, where
  a card is present, CUDA activities) that writes a Chrome trace into
  log_dir when it ends and yields the profiler, whose `key_averages()` and
  `events()` the caller may read; where the profiler cannot start it
  prints "falling back" and yields None (a tracing convenience, not a
  device path: the traced work runs the same either way).
* `StepTimer`: host per-step wall clock with a warm-up skip and a
  percentile summary. On a card `stop()` synchronizes the current stream
  first, so that a lap holds the device's work and not only its launch.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # e.g. another profiler already running
        print(f"torch.profiler unavailable ({e}); falling back to StepTimer")
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()
        self._count += 1
        if self._count > self.warmup:
            self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> dict:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {"steps": len(t), "mean_ms": float(t.mean() * 1e3),
                "p50_ms": float(np.percentile(t, 50) * 1e3),
                "p95_ms": float(np.percentile(t, 95) * 1e3)}
