"""Structured per-iteration metrics and profiling (port of
drt_tpu/utils/metrics.py).

The reference's observability is bare prints: a loss string every 100 iters
(optim.py:212-213) and one wall-clock total (optim.py:217). Here every
logged iteration emits a JSON line with loss terms, trace statistics (active
rays per bounce, TIR/miss drops, exit occlusions), the gradient maximum and
timing, plus a torch.profiler helper for kernel-level analysis.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO, Optional


class MetricsLogger:
    """Append JSON-line metrics to a file (or keep in memory)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh: Optional[IO] = open(path, "a") if path else None
        self.history: list[dict] = []
        self._t0 = time.perf_counter()

    def log(self, record: dict) -> None:
        """Values that convert to float are stored as floats (a device
        tensor is read back here), anything else as it is."""
        rec = {"t": round(time.perf_counter() - self._t0, 4)}
        for k, v in record.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of the CPU and, where there is one,
    the CUDA device into `log_dir`/trace.json (open in chrome://tracing or
    Perfetto). Yields the profiler, whose `key_averages()` sums by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
