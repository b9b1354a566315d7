"""The port's program spans on the card, per cell of BENCHMARK.json.

    python tools/profile_spans.py [--cells kitti_hdl64.revisit ...]
        [--seed N] [--window-s 20] [--on-off 0] [--out FILE]

Builds each cell's configuration, traffic and episode pool as the
benchmark does (benchmark.system, benchmark.traffic, from --seed), warms
one whole episode, then:

1. the synchronization audit (`profiling.SyncAudit`) over the pool's
   first episode with the program's spans on: every synchronizing CUDA
   call with its source line and innermost span, against the count of
   `read.*` spans;
2. a window of --window-s seconds of blocks with spans on and no
   profiler: `read.*` spans a frame and their host wall a frame (the
   time the host waited at the program's reads), `lm.iteration` spans a
   tick with work, `profiling.summary()`, and from the spans' parents
   and ids the reads by the span they sit in, each tick's host wall by
   span and the reads of each odometry frame (`by_request`);
3. the pool's first episode again under torch.profiler with spans on:
   device time, device ops, ranges and device idle by program span
   (`reduce_program_spans`), the ten longest idle gaps labelled
   `<benchmark layer>/<innermost program span>`, device time a frame
   under the `lm` and `pairs.bucket` ranges, and device ops an
   `lm.iteration` range;
4. with --on-off N, N windows with spans on and N off in turns: frames/s
   of each, the on path's cost to the host loop.

First, the cost of one span on this host: off, on, and on under a
profiler. Prints one JSON line per part and writes them all to --out
(default results/profile_spans.json). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import system, traffic  # noqa: E402
from benchmark import trace as benchtrace  # noqa: E402
from mrg_slam_tpu_torch.utils import profiling  # noqa: E402

PROGRAM = profiling.PREFIX
BENCH = benchtrace.PREFIX


# -- the reduction of a profiler trace by program span ----------------------------

def segments(ranges: List[Tuple[int, int, str]]):
    """Nested ranges (start, end, name) of one thread -> (starts, stacks):
    from starts[i] until starts[i + 1] the open ranges are stacks[i],
    outermost first."""
    bounds = []
    for a, b, name in ranges:
        bounds.append((a, 1, name))
        bounds.append((b, 0, name))
    bounds.sort()  # at one instant ends before starts
    stack: List[str] = []
    starts, stacks = [], []
    for t, opens, name in bounds:
        if opens:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        starts.append(t)
        stacks.append(tuple(stack))
    return starts, stacks


def open_at(segs, t) -> tuple:
    starts, stacks = segs
    i = bisect.bisect_right(starts, t) - 1
    return stacks[i] if i >= 0 else ()


def reduce_program_spans(events, device_kind) -> dict:
    """The profiler's raw events (`prof.profiler.kineto_results.events()`)
    -> `benchmark.trace.reduce_kineto`'s dict of them with the
    `slam.<name>` ranges' GPU-side shadows left out (as it leaves out its
    own `bench.*` ones), so its busy, layer and idle seconds count only
    device work, plus per program span name (`spans`): device seconds and
    device ops launched with it innermost (`device_s`, `ops`) and with it
    open at any depth (`device_incl_s`, `ops_incl`), its ranges
    (`ranges`), and the device's idle seconds with it innermost
    (`idle_s`, by gap midpoints); and idle seconds by
    `<benchmark layer>/<program span>` (`idle_by_label`) with the ten
    longest gaps so labelled (`idle_gaps`). A device op belongs to the
    spans open at its launch (by correlation id), else at its own start.
    The spans are those of the thread that opened the `bench.window`
    range, the thread that drives the program."""
    events = [e for e in events if not (e.device_type() == device_kind
                                         and e.name().startswith(PROGRAM))]
    red = benchtrace.reduce_kineto(events, device_kind)
    if red is None:
        return {}
    window = wthread = None
    bench: List[Tuple[int, int, str]] = []
    progs: Dict[int, list] = defaultdict(list)
    dev, launch = [], {}
    ranges: Dict[str, int] = defaultdict(int)
    for e in events:
        name = e.name()
        if e.device_type() == device_kind:
            if not name.startswith(BENCH):
                dev.append((e.start_ns(), e.end_ns(),
                            e.linked_correlation_id()))
            continue
        c = e.correlation_id()
        if c > 0:
            launch[c] = e.start_ns()
        if name.startswith(PROGRAM):
            progs[e.start_thread_id()].append(
                (e.start_ns(), e.end_ns(), name[len(PROGRAM):]))
            ranges[name[len(PROGRAM):]] += 1
        elif name == BENCH + "window":
            window, wthread = (e.start_ns(), e.end_ns()), e.start_thread_id()
        elif name.startswith(BENCH):
            bench.append((e.start_ns(), e.end_ns(), name[len(BENCH):]))
    prog = segments(progs.get(wthread, []))
    layers = segments(bench)
    ns = 1e-9
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for a, b, corr in dev:
        stack = open_at(prog, launch.get(corr, a))
        inner = stack[-1] if stack else "-"
        out[inner]["device_s"] += (b - a) * ns
        out[inner]["ops"] += 1
        for name in set(stack):
            out[name]["device_incl_s"] += (b - a) * ns
            out[name]["ops_incl"] += 1
    _, gaps = benchtrace.union([(a * ns, b * ns) for a, b, _ in dev],
                               window[0] * ns, window[1] * ns)
    by_label: Dict[str, float] = defaultdict(float)
    labelled = []
    for a, b in gaps:
        mid = (a + b) / 2 / ns
        stack = open_at(prog, mid)
        layer = (open_at(layers, mid) or ("harness",))[-1]
        out[stack[-1] if stack else "-"]["idle_s"] += b - a
        label = f"{layer}/{stack[-1]}" if stack else layer
        by_label[label] += b - a
        labelled.append([label, b - a])
    for name, n in ranges.items():
        out[name]["ranges"] = n
    labelled.sort(key=lambda g: -g[1])
    red.update(spans={k: dict(v) for k, v in out.items()},
               idle_by_label=dict(by_label), idle_gaps=labelled[:10])
    return red


def per_frame(red: dict, frames: int) -> dict:
    """A reduced trace's device time a frame under the `lm` and the
    `pairs.bucket` ranges (nested ranges included), device ops an
    `lm.iteration` range, and the device's busy time and the `tick`
    layer's device time a frame."""
    sp = red["spans"]

    def incl(name, key):
        return sp.get(name, {}).get(key, 0.0)

    it = sp.get("lm.iteration", {}).get("ranges", 0)
    return dict(
        lm_device_ms_per_frame=incl("lm", "device_incl_s") / frames * 1e3,
        pairs_device_ms_per_frame=(incl("pairs.bucket", "device_incl_s")
                                   / frames * 1e3),
        lm_device_ops_per_iteration=(incl("lm.iteration", "ops_incl") / it
                                     if it else None),
        device_ms_per_frame=red["busy_s"] / frames * 1e3,
        tick_device_ms_per_frame=(red["layer_device_s"].get("tick", 0.0)
                                  / frames * 1e3))


# -- runs -------------------------------------------------------------------------

def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def span_cost(n: int = 200000) -> dict:
    """ns a `with span(...)` costs: off, on, and on under a profiler (a
    `record_function` range besides), each net of an empty loop."""
    from torch.profiler import ProfilerActivity, profile

    def per_call(body, count):
        t0 = time.perf_counter_ns()
        body(count)
        return (time.perf_counter_ns() - t0) / count

    def bare(k):
        for _ in range(k):
            pass

    def spans(k):
        for _ in range(k):
            with profiling.span("cost"):
                pass

    base = min(per_call(bare, n) for _ in range(3))
    off = min(per_call(spans, n) for _ in range(3)) - base
    profiling.enable(True)
    on = min(per_call(spans, n // 10) for _ in range(3)) - base
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = per_call(spans, n // 100) - base
    profiling.enable(False)
    profiling.reset()
    return {"part": "span_cost", "off_ns": off, "on_ns": on,
            "on_profiled_ns": profiled, "empty_loop_ns": base}


def setup(cell_name: str, seed: int, device):
    from benchmark.run import load_config, load_spec
    spec = load_spec()
    cell = {w["name"]: w for w in spec["workloads"]}[cell_name]
    cfg = load_config(cell["config"])
    mix = traffic.load_mix(cell["traffic"])
    t0 = time.perf_counter()
    sys_ = system.System(cfg, device)
    pool = traffic.make_pool(cfg, mix, device, seed)
    wins = traffic.windows(mix)
    warm = sys_.start(pool[0], wins)
    for _ in range(warm.episode.rows.shape[0]):
        sys_.block(warm, system.Spans())
    torch.cuda.synchronize()
    return sys_, pool, wins, mix, time.perf_counter() - t0


def audit(sys_, pool, wins) -> dict:
    """The pool's first episode with spans on under the sync audit (the
    episode's fresh state made before both)."""
    run = sys_.start(pool[0], wins)
    profiling.reset()
    profiling.enable(True)
    with profiling.SyncAudit(sys_.device) as aud:
        for _ in range(run.episode.rows.shape[0]):
            sys_.block(run, system.Spans())
    profiling.enable(False)
    reads = sum(1 for r in profiling.records() if r.name.startswith("read."))
    profiling.reset()
    sites: Dict[str, int] = defaultdict(int)
    outside: Dict[str, int] = defaultdict(int)
    for f, line, span in aud.sites:
        where = f"{os.path.relpath(f, ROOT)}:{line} [{span}]"
        sites[where] += 1
        if not (span or "").startswith("read."):
            outside[where] += 1
    frames = run.blocks * sys_.B * sys_.R
    return {"syncs": aud.count(), "read_spans": reads, "frames": frames,
            "ticks": sum(t is not None for t in run.ticks),
            "sites": dict(sites), "outside_read_spans": dict(outside)}


def by_request(recs) -> dict:
    """Spans recorded in a window -> the reads split by the span they
    were read in (`read.rows_sweep` serves both the fleet's odometry and
    the pair buckets), per tick (`("tick", n)` ids) the host wall of the
    whole tick (its outermost spans) and of each span name, with the
    median and the largest over ticks, per odometry
    frame (`("frame", n)` ids) the median and the largest count of reads,
    and the threads that recorded spans."""
    reads: Dict[str, int] = defaultdict(int)
    tick: Dict[object, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    frame: Dict[object, int] = defaultdict(int)
    for r in recs:
        kind = r.id[0] if isinstance(r.id, tuple) else None
        if r.name.startswith("read."):
            reads[f"{r.name} in {r.parent or '-'}"] += 1
            if kind == "frame":
                frame[r.id] += 1
        if kind == "tick":
            tick[r.id][r.name] += r.dur_ns / 1e6
            if r.parent is None:
                tick[r.id][None] += r.dur_ns / 1e6

    def spread(name):
        ms = [t.get(name, 0.0) for t in tick.values()]
        return {"median_ms": statistics.median(ms), "max_ms": max(ms)}

    names = sorted({n for t in tick.values() for n in t if n is not None})
    counts = list(frame.values())
    return {"reads_by_parent": dict(reads), "ticks": len(tick),
            "tick_ms": spread(None) if tick else None,
            "tick_ms_by_span": {n: spread(n) for n in names},
            "reads_per_odometry_frame": (
                {"median": statistics.median(counts), "max": max(counts)}
                if counts else None),
            "threads": len({r.thread for r in recs})}


def window_spans(sys_, pool, wins, seconds: float, on: bool) -> dict:
    from benchmark.run import window
    profiling.reset()
    profiling.enable(on)
    runs, wall, _ = window(sys_, pool, wins, seconds, system.Spans())
    profiling.enable(False)
    frames = sum(r.blocks for r in runs) * sys_.B * sys_.R
    ticks = sum(t is not None for r in runs for t in r.ticks)
    out = {"on": on, "frames": frames, "window_s": wall,
           "frames_per_s": frames / wall, "ticks_with_work": ticks}
    if on:
        s = profiling.summary()
        reads = {k: v for k, v in s.items() if k.startswith("read.")}
        n_reads = sum(v["count"] for v in reads.values())
        wait_us = sum(v["total_us"] for v in reads.values())
        it = s.get("lm.iteration", {}).get("count", 0)
        out.update(host_reads_per_frame=n_reads / frames,
                   read_wait_ms_per_frame=wait_us / 1e3 / frames,
                   lm_iterations_per_tick=it / ticks if ticks else None,
                   summary=s, **by_request(profiling.records()))
    profiling.reset()
    return out


def traced(sys_, pool, wins, mix) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from benchmark.run import window
    profiling.reset()
    profiling.enable(True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if sys_.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(BENCH + "window"):
            runs, _, _ = window(sys_, pool, wins, 0.0, system.Spans(True),
                                episodes=mix["trace_episodes"], first=0)
    profiling.enable(False)
    profiling.reset()
    events = prof.profiler.kineto_results.events()
    kind = torch.autograd.DeviceType.CUDA
    t0 = time.perf_counter()
    red = reduce_program_spans(events, kind)
    red["read_s"] = time.perf_counter() - t0
    # the benchmark's own reduction of the same events, which counts the
    # program ranges' GPU-side shadows as device activity
    bench = benchtrace.reduce_kineto(events, kind)
    frames = sum(r.blocks for r in runs) * sys_.B * sys_.R
    red.update(
        part="traced", frames=frames, **per_frame(red, frames),
        bench_reduce_kineto={
            "busy_s": bench["busy_s"], "window_s": bench["window_s"],
            "layer_device_s": bench["layer_device_s"],
            "idle_by_layer": bench["idle_by_layer"]})
    return red


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+",
                    default=["kitti_hdl64.revisit", "fleet4_kitti.survey"])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--window-s", type=float, default=20.0)
    ap.add_argument("--on-off", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "results",
                                                  "profile_spans.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    lines = [span_cost()]
    log(lines[-1])
    for name in args.cells:
        sys_, pool, wins, mix, setup_s = setup(name, args.seed, dev)
        head = {"cell": name, "device": torch.cuda.get_device_name(dev),
                "seed": args.seed}
        lines.append({**head, "part": "setup", "setup_s": setup_s})
        log(lines[-1])
        lines.append({**head, "part": "audit", **audit(sys_, pool, wins)})
        log(lines[-1])
        lines.append({**head, "part": "window",
                      **window_spans(sys_, pool, wins, args.window_s, True)})
        log(lines[-1])
        lines.append({**head, **traced(sys_, pool, wins, mix)})
        log(lines[-1])
        if args.on_off:
            rates = {True: [], False: []}
            for i in range(2 * args.on_off):
                on = (i % 4) in (0, 3)  # on, off, off, on, ...
                w = window_spans(sys_, pool, wins, args.window_s, on)
                rates[on].append(w["frames_per_s"])
            lines.append({**head, "part": "on_off",
                          "window_s": args.window_s,
                          "frames_per_s_on": rates[True],
                          "frames_per_s_off": rates[False],
                          "median_on": statistics.median(rates[True]),
                          "median_off": statistics.median(rates[False])})
            log(lines[-1])
        del sys_, pool
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
