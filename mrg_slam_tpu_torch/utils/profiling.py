"""Tracing, program spans and stage timers: the port's counterpart of the
JAX package's utils/profiling.py, the analog of the reference's chrono
timers (mrg_slam_component.cpp:833-861, its timing_stats.txt dump).

- `trace(logdir)`: a context manager around `torch.profiler.profile`,
  CPU activities plus CUDA ones when a card is present; on exit it writes
  a Chrome trace (`trace.json`, chrome://tracing or Perfetto) into
  `logdir`. It yields the profile, so a caller can read
  `key_averages()` or `events()` too.
- Program spans, off by default: `enable(True)` switches them on,
  `reset()` clears them, `records()` and `summary()` read them. The
  program opens `span(name)` where its stages run: `tick.flush`,
  `tick.prefetch`, `loops.build`, `pairs.bucket`, `loops.resolve`, `lm`,
  `lm.iteration`, `graph.marginals`, `tick.post`, and `read.<site>`
  around each synchronizing host call (the reads `read.odom_gn`,
  `read.rows_sweep`, `read.pair_bucket`, `read.lm_iteration`,
  `read.cg_check`, `read.graph_packed`; the copies from pageable host
  memory `read.pose_identity`, `read.pair_rows`, `read.graph_upload`,
  which wait for the stream as a read does): a read span's count counts
  them, its wall is the time the host waited there for the card. Inside
  `request(kind)`, spans carry the id `(kind, n)`: one a tick, one an
  odometry frame. While spans are on and a torch profiler records, each
  span is also a `record_function` range named `slam.<name>`, so a
  device trace holds it on its own clock.
- `SyncAudit`: counts the synchronizing CUDA calls made while entered,
  as `torch.cuda.set_sync_debug_mode("warn")` reports them, with the
  source line and the innermost open span of each.
- `StageTimer`: wall-clock per named stage, summarized in the shape the
  reference writes to timing_stats.txt; `summary()` builds its
  per-name totals with one.

On the card a stage measures what the host spent in it. CUDA launches
return before the device has run them, so a stage that ends without a
host read (`.item()`, `.cpu()`, a synchronize) times the launches, not
the device work; the device time lands in whichever later stage reads.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import warnings
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

PREFIX = "slam."


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
        self._self: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append((time.perf_counter() - t0) * 1e6)

    def add(self, name: str, us: float, self_us: float) -> None:
        """One finished stage of `us`, `self_us` of it outside nested
        stages."""
        self._acc[name].append(us)
        self._self[name] = self._self.get(name, 0.0) + self_us

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._acc.items():
            out[name] = {"count": len(xs), "total_us": sum(xs),
                         "avg_us": sum(xs) / max(len(xs), 1),
                         "max_us": max(xs)}
            if name in self._self:
                out[name]["self_us"] = self._self[name]
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for name, s in sorted(self.summary().items()):
                f.write(f"{name} count {s['count']} avg_us {s['avg_us']:.1f}"
                        f" max_us {s['max_us']:.1f}\n")


# -- program spans -------------------------------------------------------------

class Span(NamedTuple):
    """One finished span. `start_ns` is on `time.time_ns()`, the clock of
    torch.profiler's events; the durations are on `perf_counter_ns`."""

    name: str
    start_ns: int
    dur_ns: int
    self_ns: int               # dur_ns less the spans nested in it
    parent: Optional[str]      # the innermost span open at its start
    thread: int
    id: object                 # the open `request`'s (kind, n), or None


_on = False
_records: List[Span] = []
_local = threading.local()


class _Off:
    """The span of the off path: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Open:
    __slots__ = ("name", "id", "parent", "start", "t0", "child", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = getattr(_local, "request", None)
        stack.append(self)
        self.child = 0
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.start = time.time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        parent = self.parent
        if parent is not None:
            parent.child += dur
        _records.append(Span(self.name, self.start, dur, dur - self.child,
                             None if parent is None else parent.name,
                             threading.get_ident(), self.id))
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def enable(on: bool) -> None:
    """Switch the program's spans on or off (off by default)."""
    global _on
    _on = bool(on)


def reset() -> None:
    """Forget every recorded span."""
    _records.clear()


def span(name: str):
    """A context manager around one stage of the program. Off, it is one
    shared object that does nothing. On, it records a `Span` whose `id`
    is that of the thread's open `request`, else None."""
    if not _on:
        return OFF
    return _Open(name)


class _Request:
    __slots__ = ("id", "prev")

    def __init__(self, id):
        self.id = id

    def __enter__(self):
        self.prev = getattr(_local, "request", None)
        _local.request = self.id
        return self

    def __exit__(self, *exc):
        _local.request = self.prev
        return False


_requests: Dict[str, Iterator[int]] = defaultdict(itertools.count)


def request(kind: str):
    """A context manager whose spans on this thread carry the id
    `(kind, n)`, n counting the requests of that kind while spans were on:
    the program opens one a tick (`"tick"`) and one an odometry frame
    (`"frame"`; the frames' stamps stay on the card, where reading one
    would add a synchronizing read)."""
    if not _on:
        return OFF
    return _Request((kind, next(_requests[kind])))


def records() -> List[Span]:
    """The spans recorded since the last `reset()`, in the order they
    ended."""
    return list(_records)


def summary() -> Dict[str, Dict[str, float]]:
    """Per span name: count, total_us, avg_us, max_us and self_us."""
    t = StageTimer()
    for r in list(_records):
        t.add(r.name, r.dur_ns / 1e3, r.self_ns / 1e3)
    return t.summary()


def _innermost() -> Optional[str]:
    """The name of the innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1].name if stack else None


# -- the synchronization audit ---------------------------------------------------

class SyncAudit:
    """Counts the synchronizing CUDA calls made while entered, as
    `torch.cuda.set_sync_debug_mode("warn")` reports them (each costs a
    Python warning, a few us), and keeps the source line and the
    innermost open span (None where spans are off or none is open) of
    each in `sites`. Other warnings raised meanwhile are dropped. On the
    CPU it counts nothing."""

    MESSAGE = "called a synchronizing CUDA operation"

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda"
        self.sites: List[tuple] = []  # (file, line, innermost span)

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if self.MESSAGE in str(message):
            self.sites.append((filename, lineno, _innermost()))

    def __enter__(self):
        if self.on:
            self._catch = warnings.catch_warnings()
            self._catch.__enter__()
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode("default")
            self._catch.__exit__(*exc)
        return False

    def count(self) -> Optional[int]:
        return len(self.sites) if self.on else None
