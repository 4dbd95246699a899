"""Step timing, device traces and device memory.

Counterpart of ``eamm_tpu/utils/profiling.py``:

- ``StepTimer``: wall-clock seconds between ``tick()`` calls, after
  ``warmup`` steps, summarized as mean, p50, p95 and steps per second;
- ``trace``: a ``torch.profiler`` run (CPU and, when there is one, CUDA
  activity) around a block, written into a directory as a Chrome trace
  that TensorBoard's profiler plugin or ``chrome://tracing`` opens;
- ``device_memory_stats``: per CUDA device, its bytes in use, the peak
  and the total (``torch.cuda.memory_stats``).

The JAX package also points XLA at a persistent compilation cache
(``enable_persistent_compilation_cache``).  The port has no counterpart to
set up: it compiles nothing per call, and its CUDA kernels are built once
per source and flags into ``kernels.BUILD_DIR`` (``build/kernels/`` at the
repository root) and reused from there, which is its compilation cache.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


class StepTimer:
    """Collects step durations; call ``tick()`` once per step."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: list[float] = []
        self._last: float | None = None
        self._count = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self._times.append(now - self._last)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / np.mean(self._times) if self._times else float("nan")

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        t = np.asarray(self._times)
        return {"steps": len(t),
                "mean_ms": float(t.mean() * 1e3),
                "p50_ms": float(np.percentile(t, 50) * 1e3),
                "p95_ms": float(np.percentile(t, 95) * 1e3),
                "steps_per_sec": float(1.0 / t.mean())}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write
    ``<log_dir>/trace.json``; yields the profiler (its ``key_averages()``
    sums time by operator and kernel)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> list[dict]:
    """Per CUDA device: its name, bytes in use, peak bytes in use and
    total bytes (empty without a CUDA device)."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        stats = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i}",
                    "name": torch.cuda.get_device_name(i),
                    "bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                    "bytes_limit": torch.cuda.get_device_properties(i)
                    .total_memory})
    return out
