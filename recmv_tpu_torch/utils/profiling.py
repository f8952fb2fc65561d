"""Tracing and phase timers (counterpart of ``recmv_tpu/utils/profiling.py``):
a ``torch.profiler`` trace exported for Chrome/Perfetto, wall-time phase
timers aggregated per name, and named regions in the trace. The names
and the ``summary()`` / ``dump()`` layout are the JAX module's."""

from __future__ import annotations

import contextlib
import json
import os
import os.path as osp
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's where there is one) into ``<log_dir>/trace.json``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


class PhaseTimers:
    """Accumulates wall time per named phase. With ``sync=True`` a phase
    given a ``result`` ends with ``torch.cuda.synchronize()`` once the
    process has used the card, so the time covers the device's work; on
    the CPU there is nothing to wait for."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if self.sync and result is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_s": round(v / max(self.counts[k], 1), 4)}
                for k, v in sorted(self.totals.items())}

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler traces."""
    with torch.profiler.record_function(name):
        yield
