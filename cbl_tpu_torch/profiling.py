"""Profiling & observability.

Counterpart of `cbl_tpu/profiling.py`: a `torch.profiler` trace around
any region (host activity, and the card's kernels and copies where a
CUDA device is present), and a k-mers/s throughput meter used by the CLI.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace of the region and write it as a
    Chrome trace, `log_dir/trace.json` (open in chrome://tracing or
    Perfetto); yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class ThroughputMeter:
    """Wall-clock k-mers/s counter (stderr report)."""

    def __init__(self, label: str = "throughput"):
        self.label = label
        self.t0 = time.time()
        self.items = 0

    def add(self, n: int) -> None:
        self.items += n

    def report(self, file=sys.stderr) -> float:
        dt = max(time.time() - self.t0, 1e-9)
        rate = self.items / dt
        print(f"{self.label}: {self.items} k-mers in {dt:.2f}s = {rate:,.0f}/s",
              file=file)
        return rate
