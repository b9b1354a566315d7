"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (timed as `setup_s`, from this module's first line): the pool of
episodes (each its own world and scans) is made on the card from the
seed, the port's kernels are loaded (built by nvcc on the first run in a
checkout), and one episode runs once through every layer. The window
then drives episodes of blocks back to back, each block through the
prefilter, the odometry with its one host read, `process_scan` per frame
and robot, and one `optimization_tick`; it closes at the first block
boundary at or after --seconds. `frames_per_s` is every frame of the
window over all of its time. After the window, the mix's
`trace_episodes` episodes from the pool's first run once more under
torch.profiler: with --trace 1 always, with --trace 0 where one of the
cell's end-to-end metrics comes from the device trace
(`device_ms_per_frame`: the device's busy time over those episodes'
frames). With --trace 1 the line carries the per-layer metrics instead:
the host-wall ones from the window, run as without the trace, and the
device ones from the traced episodes.

After the window, one finished episode drawn from the seed is judged
against the plain reference (`reference/judge.py`); `correct` is whether
every compared number is within its limit in the configuration file.
The last line of standard output is the result; the compared numbers are
also the last lines of standard error. Without a CUDA card it exits
non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = HERE / "out"
# every cache a library could keep goes to a fixed place in the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(OUT / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(OUT / "triton"))
os.environ.setdefault("USE_FLAX", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import guard, peaks, system, traffic  # noqa: E402
from . import trace as tracelib  # noqa: E402
from .reference import judge  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def merge(into: dict, new: dict) -> None:
    """Deep-merge `new` into `into` (dicts merge key by key)."""
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            merge(into[k], v)
        else:
            into[k] = v


def reader(name: str):
    """The per-layer metric reader `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """Names of the metrics a cell reports in a run of this kind."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key]
            if "workloads" not in m or cell in m["workloads"]]


class Sampler:
    """nvidia-smi's SM clock, power draw and temperature every 500 ms
    beside the window (a host process, not on the card)."""

    QUERY = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "500", "-i", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except FileNotFoundError:
            self.proc = None

    def stop(self) -> str:
        if self.proc is None:
            return "not sampled"
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        cols = []
        for line in out.splitlines():
            try:
                cols.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        if not cols:
            return "no samples"
        parts = []
        for i, name in enumerate(("sm_mhz", "power_w", "temp_c")):
            v = [c[i] for c in cols]
            parts.append(f"{name} min {min(v)} median "
                         f"{statistics.median(v)} max {max(v)}")
        return f"{len(cols)} samples: " + "; ".join(parts)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(sys_, pool, windows, seconds, spans, episodes=None, first=0):
    """The pool's episodes back to back from `first`, round and round;
    closes at the first block boundary at or after `seconds`, or after
    `episodes` whole episodes. -> (runs, seconds from the window's start
    to its last block's end, the seconds at which each episode ended)."""
    runs, ends = [], []
    sync(sys_.device)
    t0 = time.perf_counter()
    i, done = first, False
    while not done:
        run = sys_.start(pool[i % len(pool)], windows)
        i += 1
        runs.append(run)
        for _ in range(run.episode.rows.shape[0]):
            sys_.block(run, spans)
            if episodes is None and time.perf_counter() - t0 >= seconds:
                done = True
                break
        ends.append(time.perf_counter() - t0)
        if episodes is not None and len(runs) >= episodes:
            done = True
    sync(sys_.device)
    return runs, time.perf_counter() - t0, ends


def main(argv=None, device=None, overrides=None, fault=None) -> int:
    """Run a cell; 0 when it printed a result. `device`, `overrides`
    (dicts merged into the config and the mix) and `fault` (a callable
    given the System before the window) serve the benchmark's own tests,
    which run the harness on the CPU at a small size."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        log(f"unknown workload {args.workload!r}")
        return 2
    cell = cells[args.workload]
    cfg = load_config(cell["config"])
    mix = traffic.load_mix(cell["traffic"])
    merge(cfg, (overrides or {}).get("config", {}))
    merge(mix, (overrides or {}).get("traffic", {}))
    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA card: this benchmark runs on one")
            return 3
        if torch.cuda.device_count() < cell["chips"]:
            log(f"{torch.cuda.device_count()} CUDA cards, the cell asks for "
                f"{cell['chips']}")
            return 3
        device = "cuda"
    dev = torch.device(device)
    traced = bool(args.trace)
    e2e = cell_metrics(spec, cell["name"], False)
    # the device's numbers come from episodes traced after the window
    profiled = traced or any(m["source"] == "device_trace" for m in e2e)

    # -- set-up -----------------------------------------------------------------
    sys_ = system.System(cfg, dev)
    pool = traffic.make_pool(cfg, mix, dev, args.seed)
    wins = traffic.windows(mix)
    # one whole episode through every layer: a block alone leaves the
    # first episode of the window ~10 % slower than its second pass over
    # the same data (revisit), as the loop closure's pair buckets, the
    # store's growth past its first capacity and the LM at the grown size
    # first come late in an episode
    warm = sys_.start(pool[0], wins)
    for _ in range(warm.episode.rows.shape[0]):
        sys_.block(warm, system.Spans())
    del warm
    if fault is not None:
        fault(sys_)
    sync(dev)
    setup_s = time.perf_counter() - T_PROCESS

    # -- the window ---------------------------------------------------------------
    launches0 = system.launches()
    sampler = Sampler() if dev.type == "cuda" else None
    spans = system.Spans()
    runs, wall, ends = window(sys_, pool, wins, args.seconds, spans)
    clocks = sampler.stop() if sampler else "not sampled"
    launches = {k: v - launches0[k] for k, v in system.launches().items()}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    reduced, traced_runs = None, []
    if profiled:
        # the device's metrics from episodes after the window, under the
        # profiler (which slows the host, so no host wall is read here);
        # the same episodes from the pool's first in every run, whatever
        # the window reached
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(tracelib.PREFIX + "window"):
                traced_runs, _, _ = window(
                    sys_, pool, wins, 0.0, system.Spans(True),
                    episodes=mix["trace_episodes"], first=0)
        peak = max(peak, torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    found = guard.forbidden_loaded()
    if found:
        log(f"the window loaded {', '.join(found)}: the benchmark measures "
            "the port alone")
        return 4
    if profiled:
        kind = torch.autograd.DeviceType.CUDA
        t0 = time.perf_counter()
        reduced = tracelib.reduce_kineto(
            prof.profiler.kineto_results.events(), kind)
        log(f"# trace: {reduced['device_events'] if reduced else 0} device "
            f"events read in {time.perf_counter() - t0:.1f} s")
        del prof

    # -- what the window did ------------------------------------------------------------
    B, R = sys_.B, sys_.R
    frames = sum(r.blocks for r in runs) * B * R
    ticks = [t for r in runs for t in r.ticks if t is not None]
    failed = 0
    for r in runs:
        host = np.concatenate(r.host).reshape(r.blocks, R, B, 10)
        inl = host[..., 9].transpose(1, 0, 2).reshape(R, -1)
        failed += int((inl[:, 1:] <= 0).sum())
    pair_rows = [sum(n for n, _ in t.pair_buckets) for t in ticks]
    log(f"# card: {card_line()}; device {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    log(f"# clocks beside the window: {clocks}")
    log(f"# peak device memory (max_memory_allocated): {peak} bytes")
    log(f"# window: {wall:.6f} s, {len(runs)} episodes "
        f"({sum(r.complete for r in runs)} complete), "
        f"{sum(r.blocks for r in runs)} blocks, {frames} frames, "
        f"{len(ticks)} ticks with work")
    rates = [r.blocks * B * R / (e - s) for r, s, e in
             zip(runs, [0.0] + ends[:-1], ends)]
    log(f"# frames/s of each episode of the window: {json.dumps(rates)}")
    log(f"# hand-kernel launches in the window: {json.dumps(launches)}")
    log(f"# pair program rows a tick: {json.dumps(pair_rows)} (mean "
        f"{np.mean(pair_rows) if pair_rows else 0:.2f}, max "
        f"{max(pair_rows) if pair_rows else 0})")

    trace_frames = sum(r.blocks for r in traced_runs) * B * R
    if reduced:
        log(f"# traced after the window: {len(traced_runs)} episode(s), "
            f"{trace_frames} frames, device busy {reduced['busy_s']!r} s "
            f"of {reduced['window_s']!r} s")
        log(f"# device idle by host layer (s): "
            f"{json.dumps(reduced['idle_by_layer'])}")
        log(f"# device time by layer (s): "
            f"{json.dumps(reduced['layer_device_s'])}")

    metrics = {}
    if traced:
        rec = record(sys_, runs, traced_runs, ticks, spans, reduced, frames,
                     wall)
        for m in cell_metrics(spec, cell["name"], True):
            v = reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        busy = reduced["busy_s"] if reduced else 0.0
        values = {"frames_per_s": frames / wall, "setup_s": setup_s,
                  # none where no operation ran on a card (a CPU run)
                  "device_ms_per_frame": (busy / trace_frames * 1e3
                                          if busy and trace_frames
                                          else None)}
        for m in e2e:
            if values[m["name"]] is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    # -- correct: one finished episode against the reference ---------------------------
    done = [r for r in runs if r.complete] or runs[-1:]
    pick = done[int(np.random.default_rng([args.seed % 2 ** 63, 3])
                    .integers(len(done)))]
    out = system.outputs(sys_, pick, wins)
    for r in runs + traced_runs:
        if r is not pick:
            r.slam = r.carry = None
            r.clouds.clear()
    pool = [e if e is pick.episode else None for e in pool]
    del traced_runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nums, details = judge.judge(cfg, pick.episode, out, dev, args.seed)
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in nums.items()}
    correct = bool(nums) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    log(f"# judged episode {pick.episode.index} ({pick.blocks} blocks): "
        f"{json.dumps(details)}; reference {time.perf_counter() - t0:.1f} s")
    found = guard.forbidden_loaded()
    if found:
        log(f"loaded {', '.join(found)}: the benchmark measures the port "
            "alone")
        return 4
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    result = {
        "correct": correct, "attempted": frames, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}}
    if traced and reduced:
        result["device"].update(busy_s=reduced["busy_s"],
                                window_s=reduced["window_s"])
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


def record(sys_, runs, traced_runs, ticks, spans, reduced, frames, wall):
    """What the per-layer readers take from a traced run: the window's
    frames, length, ticks, host wall and GN iterations, and the traced
    episodes' frames and least time of their odometry work."""
    R, B = sys_.R, sys_.B
    gn = sum(int(np.concatenate(r.host)[:, 7].sum()) for r in runs)
    bound = 0.0
    for r in traced_runs:
        valid = torch.stack([m.sum(-1) for _, m in r.clouds]).cpu().numpy()
        host = np.concatenate(r.host).reshape(r.blocks, R, B, 10)
        valid = valid.reshape(r.blocks, R, B).transpose(1, 0, 2).reshape(R,
                                                                         -1)
        iters = host[..., 7].transpose(1, 0, 2).reshape(R, -1)
        flags = host[..., 8].transpose(1, 0, 2).reshape(R, -1) > 0.5
        for rr in range(R):
            kf = None
            for f in range(valid.shape[1]):
                n_tgt = int(valid[rr, kf]) if kf is not None else 0
                bound += peaks.odometry_frame_s(int(valid[rr, f]), n_tgt,
                                                int(iters[rr, f]))
                if flags[rr, f]:
                    kf = f
    return types.SimpleNamespace(
        frames=frames, window_s=wall, ticks=ticks, wall_s=dict(spans.wall),
        gn_iterations=gn,
        trace_frames=sum(r.blocks for r in traced_runs) * B * R,
        odometry_bound_s=bound, trace=reduced)


if __name__ == "__main__":
    sys.exit(main())
