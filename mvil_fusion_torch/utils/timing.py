"""Timing / tracing instrumentation.

Counterpart of ``mvil_fusion_tpu/utils/timing.py``: the reference's ad-hoc
TicToc wall-clock timers scattered through every node (reference:
vils_estimator/src/utility/tic_toc.h and the copies in each package;
printStatistics in visualization.cpp — SURVEY.md §5) as one structured
registry, and a device trace: `torch_trace` writes a Chrome trace of
`torch.profiler` where the reference's `xla_trace` wrote an XLA trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass

import torch


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / max(self.count, 1)


class Profiler:
    """Hierarchical wall-clock stage timing with a summary table."""

    def __init__(self):
        self.stats: dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = False):
        """Time the body; with `sync` the card's queued work is waited for
        first, so that it is counted (nothing to wait for without one)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s.count += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)

    def summary(self) -> str:
        rows = [f"{'stage':<28}{'count':>8}{'mean ms':>10}{'max ms':>10}"]
        for name in sorted(self.stats):
            s = self.stats[name]
            rows.append(f"{name:<28}{s.count:>8}{s.mean_ms:>10.2f}"
                        f"{1000 * s.max_s:>10.2f}")
        return "\n".join(rows)

    def reset(self):
        self.stats.clear()


PROFILER = Profiler()


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Capture a device trace viewable in Perfetto or chrome://tracing:
    `torch.profiler` over the body (host and, where there is a card, its
    kernels), written to `logdir`/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
