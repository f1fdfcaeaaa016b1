"""Tracing and timing: the counterpart of
`multimodal_rare_disease_tpu/utils/profiling.py`.

- `trace(logdir)`: a torch.profiler trace (CPU, and CUDA where a card is
  present) around any block, written to `logdir` as a Chrome trace
  (chrome://tracing, Perfetto);
- `StepTimer`: host-clock step timing with warm-up discard and the JAX
  package's summary keys (the caller synchronizes the device inside the
  timed block when the step's device work should count);
- `device_memory_stats()`: the current and peak allocated memory of each
  CUDA device.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: with trace("/tmp/trace"): run_steps(). Yields the
    profiler; its trace lands in `logdir/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / TRACE_FILE))


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return False

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        a = np.asarray(self._times)
        return {
            "steps": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p95_ms": float(np.percentile(a, 95) * 1e3),
            "total_s": float(a.sum()),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """{"cuda:i": {"bytes_in_use_mb", "peak_bytes_in_use_mb"}} for every
    CUDA device (empty without one): torch's caching allocator's
    allocated bytes, in MB as the JAX package reports them."""
    out = {}
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": torch.cuda.memory_allocated(i) / 1e6,
            "peak_bytes_in_use_mb": torch.cuda.max_memory_allocated(i) / 1e6,
        }
    return out
