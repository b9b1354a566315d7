"""Tracing and stage timers: the port's counterpart of the JAX package's
utils/profiling.py, the analog of the reference's chrono timers
(mrg_slam_component.cpp:833-861, its timing_stats.txt dump).

- `trace(logdir)`: a context manager around `torch.profiler.profile`,
  CPU activities plus CUDA ones when a card is present; on exit it writes
  a Chrome trace (`trace.json`, chrome://tracing or Perfetto) into
  `logdir`. It yields the profile, so a caller can read
  `key_averages()` or `events()` too.
- `StageTimer`: wall-clock per named stage, summarized in the shape the
  reference writes to timing_stats.txt.

On the card a stage measures what the host spent in it. CUDA launches
return before the device has run them, so a stage that ends without a
host read (`.item()`, `.cpu()`, a synchronize) times the launches, not
the device work; the device time lands in whichever later stage reads.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator["torch.profiler.profile"]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    def __init__(self):
        self._acc: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append((time.perf_counter() - t0) * 1e6)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._acc.items():
            out[name] = {"count": len(xs), "total_us": sum(xs),
                         "avg_us": sum(xs) / max(len(xs), 1),
                         "max_us": max(xs)}
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for name, s in sorted(self.summary().items()):
                f.write(f"{name} count {s['count']} avg_us {s['avg_us']:.1f}"
                        f" max_us {s['max_us']:.1f}\n")
