"""Reduction of a torch.profiler trace to the numbers the readers take.

The traced window is the `bench.window` range; the layers are the
`bench.<layer>` ranges the harness puts around its calls into the port.
Only device activity (kernels, copies, fills) counts as busy. Nothing of
the trace is written to disk.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "bench."


def union(intervals: List[Tuple[float, float]], lo: float, hi: float
          ) -> Tuple[float, List[Tuple[float, float]]]:
    """Length of the union of intervals clipped to [lo, hi], and the gaps
    between its pieces inside [lo, hi] (start, end)."""
    busy, gaps, cur = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def reduce_kineto(events, device_kind) -> Optional[dict]:
    """The profiler's raw events (`prof.profiler.kineto_results.events()`,
    read without building the profiler's own event tree, which takes
    minutes for a window of this size) -> window, device busy time and
    gaps, device time under each layer's ranges, device time by op name
    (seconds). A device op belongs to the layer range its launching op
    started in (by correlation id), or else the one its own start falls
    in. None when the trace holds no window."""
    window = None
    host: List[Tuple[int, int, str]] = []
    dev = []
    launch = {}  # correlation id -> start of the host op (one pass)
    for e in events:
        name = e.name()
        if e.device_type() == device_kind:
            if not name.startswith(PREFIX):  # not a range's GPU shadow
                dev.append((e.start_ns(), e.end_ns(), name,
                            e.linked_correlation_id()))
            continue
        c = e.correlation_id()
        if c > 0:
            launch[c] = e.start_ns()
        if name.startswith(PREFIX):
            if name == PREFIX + "window":
                window = (e.start_ns(), e.end_ns())
            else:
                host.append((e.start_ns(), e.end_ns(), name[len(PREFIX):]))
    if window is None:
        return None
    host.sort()
    starts = [h[0] for h in host]

    def layer(t):  # the layer range the host was in at time t (ns)
        i = bisect.bisect_right(starts, t) - 1
        return host[i][2] if i >= 0 and host[i][1] >= t else "harness"

    ns = 1e-9
    layers: Dict[str, float] = defaultdict(float)
    ops: Dict[str, float] = defaultdict(float)
    for a, b, name, corr in dev:
        layers[layer(launch.get(corr, a))] += (b - a) * ns
        ops[name[:120]] += (b - a) * ns
    busy, gaps = union([(a * ns, b * ns) for a, b, _, _ in dev],
                       window[0] * ns, window[1] * ns)
    idle_by_layer: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        idle_by_layer[layer((a + b) / 2 / ns)] += b - a
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[layer((a + b) / 2 / ns), b - a] for a, b in gaps[:10]]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(window[1] - window[0]) * ns, busy_s=busy,
                layer_device_s=dict(layers),
                device_ops=[[n, t] for n, t in top], idle_gaps=named,
                idle_by_layer=dict(idle_by_layer), device_events=len(dev))
