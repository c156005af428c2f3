"""Profiling helpers (the port's counterpart of ``tpurec/utils/profiling.py``):
``torch.profiler`` traces in place of JAX's, and per-step timing.  In a
process group (a mesh's ranks) only rank 0 writes a trace, and only rank
0's timer keeps a summary."""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict

import torch

from tpurec_torch.utils.logging import is_rank0


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, when a card is
    present, CUDA activity; on exit it is written under ``log_dir`` as
    ``<host>.<pid>.<ms>.pt.trace.json`` (Chrome/Perfetto, and TensorBoard's
    profiler plugin); on a rank other than 0 nothing is written.  Yields
    the profiler (``key_averages()``, ...)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if not is_rank0():
        return
    os.makedirs(log_dir, exist_ok=True)
    name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns() // 10**6}"
    prof.export_chrome_trace(os.path.join(log_dir, name + ".pt.trace.json"))


class StepTimer:
    """Wall-clock step timing with warmup discard and percentile summary
    (empty on a rank other than 0)."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._times = []
        self._count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self._times or not is_rank0():
            return {}
        import numpy as np

        a = np.asarray(self._times)
        return {
            "steps": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p95_ms": float(np.percentile(a, 95) * 1e3),
            "max_ms": float(a.max() * 1e3),
        }
