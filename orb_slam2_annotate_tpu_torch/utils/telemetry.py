"""Per-stage timing telemetry and torch.profiler integration (port of
utils/telemetry.py).

Named stage timers with streaming stats, a context manager that also opens
a ``torch.profiler.record_function`` span of the stage's name (visible in
a profiler trace), a one-line-a-stage report, and ``profile_trace``, which
writes a Chrome trace of a block.

A stage is timed with ``time.perf_counter`` around its host code.  On the
card that is the host's dispatch of the stage: kernels it launched may
still run after it returns, as with the reference's asynchronous JAX
dispatch.  A caller that wants device time synchronizes inside the stage.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.profiler import record_function


@dataclass
class StageStats:
    count: int = 0
    total: float = 0.0
    best: float = float("inf")
    worst: float = 0.0
    samples: list = field(default_factory=list)

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.best = min(self.best, dt)
        self.worst = max(self.worst, dt)
        if len(self.samples) < 10000:
            self.samples.append(dt)

    @property
    def mean(self):
        return self.total / max(self.count, 1)

    @property
    def median(self):
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[len(s) // 2]


class Telemetry:
    """Per-stage wall-clock stats; each stage also a profiler span (which
    costs nothing unless a profiler is recording)."""

    def __init__(self):
        self.stages: dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with record_function(name):
            yield
        self.stages[name].add(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, st in sorted(self.stages.items()):
            lines.append(
                f"{name:<28s} n={st.count:5d} median={st.median*1e3:8.2f}ms "
                f"mean={st.mean*1e3:8.2f}ms worst={st.worst*1e3:8.2f}ms"
            )
        return "\n".join(lines)

    def reset(self):
        self.stages.clear()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block (host, and the card when there is one) and write
    its Chrome trace to `logdir`/trace.json (open in chrome://tracing or
    Perfetto).  Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
