"""The dense LM iteration's kernels (graph/lm_dense.py) on a card, at the
main path's graph shapes, against the op path they replace.

    python tools/time_lm_dense.py [--out results/lm_dense.json]

For each shape (node and edge capacities 128 / 512 and 256 / 1024, the
single-robot store before and after it grows; 3/4 of the nodes live, a
ring with a Huber chord every fourth node, as loops are), it
- solves the graph with `solve.optimize` (the kernels) under
  torch.profiler: device time of each kernel per launch, device ops,
  device time and host wall per LM iteration;
- runs the same number of op-path iterations (graph/solve.py's ops:
  linearize, assemble_dense, dense_delta, _retract_all, linearize,
  _lm_schedule, _take), the same way;
- times each kernel alone, one call between CUDA events (`ms`, the
  wrapper's host time included), and its plain twin's stage the same way
  (`plain_ms`: linearize + assemble_dense + equilibrate for the first
  two kernels together, the trial's retraction, chi2 and schedule for
  the third);
- gives each kernel's least time on the published H100 SXM peaks (bytes
  at 3.35 TB/s, FP32 at 67 TFLOP/s, FP64 at 34 TFLOP/s) from the bytes
  and operations its live rows need.
With --cells, it then runs each named cell of BENCHMARK.json (its
configuration and traffic, the episode pool drawn from --seed) through
the pool's episodes, and solves every tick's graph twice: as the program
does (the kernels), and by the op path on the same input graph on the
same card. The episode goes on from the kernels' result. Per cell: the
LM iterations of each path tick by tick, how many ticks each path took
more, and the gap of their final chi2.

Prints one JSON line (also written to --out): the card's name and power
limit, the rows and the cells. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
# operations an edge row costs (float32, float64) and bytes it moves
LIN_F32, LIN_F64 = 3300, 900          # residual, products; the Jacobians
LIN_BYTES = 2 * 28 + 28 + 144 + 17 + 121 * 4
TRIAL_EDGE_F32, TRIAL_EDGE_BYTES = 400, 2 * 28 + 28 + 144 + 17
TRIAL_NODE_F32, TRIAL_NODE_BYTES = 250, 3 * 28 + 5 * 24


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ring(cap_n, cap_e, device):
    from mrg_slam_tpu_torch.pipeline.baseline_runs import build_ring_graph
    from mrg_slam_tpu_torch.utils import se3np

    n = 3 * cap_n // 4
    g = build_ring_graph(n_nodes=n, capacity_nodes=cap_n,
                         capacity_edges=cap_e, backend="dense", seed=1,
                         device=device)
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    for i in range(0, n - n // 2, 4):
        j = i + n // 2
        g.add_se3_edge(i, j, se3np.pose_between(g.poses[i], g.poses[j]),
                       info * 0.25, kernel="Huber", kernel_delta=1.0)
    return g


def bounds_ms(idx, cap_n, n_live, e_live) -> dict:
    """Each kernel's least time on the published peaks, from the bytes and
    operations of a graph's live rows (`idx` its LMIndex) -> {kernel:
    (ms, "bytes" or "operations")}."""
    blocks = idx.blocks.cpu().numpy().reshape(-1, 4)
    contribs = int(blocks[:, 3].max())
    k_live = int((blocks[:, 0] >= 0).sum())
    asm_bytes = 4 * (36 * contribs + 12 * contribs + 72 * k_live
                     + 5 * 6 * cap_n) + 4 * contribs
    work = {  # (bytes s, operations s)
        "lm_linearize": (e_live * LIN_BYTES / PEAK_BYTES,
                         e_live * (LIN_F32 / PEAK_F32 + LIN_F64 / PEAK_F64)),
        "lm_assemble": (asm_bytes / PEAK_BYTES, 36 * contribs / PEAK_F32),
        "lm_trial": (
            (e_live * TRIAL_EDGE_BYTES + n_live * TRIAL_NODE_BYTES)
            / PEAK_BYTES,
            (e_live * TRIAL_EDGE_F32 + n_live * TRIAL_NODE_F32) / PEAK_F32),
    }
    return {k: (1e3 * max(t), "bytes" if t[0] >= t[1] else "operations")
            for k, t in work.items()}


def event_ms(torch, fn, reps=50, before=None):
    """Median of one fn() between CUDA events; `before` runs outside."""
    for _ in range(3):
        if before:
            before()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def profiled(torch, fn):
    """fn() under torch.profiler -> (device us by kernel name and count,
    device ops, device ms, host wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, ops, dev_us = {}, 0, 0.0
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        us = ev.device_time_total if hasattr(ev, "device_time_total") \
            else ev.cuda_time_total
        ops += 1
        dev_us += us
        t, c = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (t + us, c + 1)
    return by_name, ops, dev_us / 1e3, wall


def op_path_iterations(torch, g, cfg, n_iter):
    """The op path's LM loop body (graph/solve.py's dense backend),
    `n_iter` times, no stop."""
    from mrg_slam_tpu_torch.graph import solve

    n = g.n_nodes
    lin = solve.linearize(g)
    chi2 = lin.chi2
    lam = torch.full((), cfg.lm_initial_lambda, device=g.poses.device)
    nu = torch.full_like(lam, 2.0)
    for _ in range(n_iter):
        H, b, free = solve.assemble_dense(g, lin)
        x, pred = solve.dense_delta(H, b, free, lam)
        g_new = solve._retract_all(g, x[:6 * n].view(n, 6),
                                   x[6 * n:].view(0, 3))
        lin_new = solve.linearize(g_new)
        accept, lam, nu, _ = solve._lm_schedule(
            chi2, lin_new.chi2, pred, lam, nu, True, cfg.chi2_rel_tol)
        g, lin = solve._take(accept, g_new, lin_new, g, lin)
        chi2 = torch.where(accept, lin_new.chi2, chi2)
        bool(accept)  # the op path's one read an iteration


def both_paths(torch, cell_name, seed, device):
    """Every tick solve of a cell's episode pool by the kernels and by the
    op path on the same graph -> a summary and the ticks."""
    from benchmark import system, traffic
    from benchmark.run import load_config, load_spec
    from mrg_slam_tpu_torch.graph import lm_dense, solve

    cell = {w["name"]: w for w in load_spec()["workloads"]}[cell_name]
    cfg = load_config(cell["config"])
    mix = traffic.load_mix(cell["traffic"])
    sys_ = system.System(cfg, device)
    pool = traffic.make_pool(cfg, mix, device, seed)
    wins = traffic.windows(mix)
    ticks = []
    program = solve.optimize
    takes = lm_dense.takes_kernels

    def optimize(g, cfg_, **kw):
        res = program(g, cfg_, **kw)
        if res.fused:
            lm_dense.takes_kernels = lambda *a, **k: False
            try:
                op = program(g, cfg_, **{k: v for k, v in kw.items()
                                         if k != "index"})
            finally:
                lm_dense.takes_kernels = takes
            ticks.append(dict(
                nodes=int(g.node_mask.sum()), edges=int(g.se3.mask.sum()),
                kernels=int(res.iterations), op_path=int(op.iterations),
                chi2_initial=float(res.chi2_initial),
                chi2_kernels=float(res.chi2_final),
                chi2_op_path=float(op.chi2_final)))
        return res

    solve.optimize = optimize
    try:
        for episode in pool:
            run = sys_.start(episode, wins)
            for _ in range(run.episode.rows.shape[0]):
                sys_.block(run, system.Spans())
    finally:
        solve.optimize = program
    k = np.array([t["kernels"] for t in ticks])
    o = np.array([t["op_path"] for t in ticks])
    gap = [abs(t["chi2_kernels"] - t["chi2_op_path"])
           / max(t["chi2_op_path"], 1e-12) for t in ticks]
    return dict(cell=cell_name, seed=seed, episodes=len(pool),
                ticks=len(ticks), kernels_per_tick=float(k.mean()),
                op_path_per_tick=float(o.mean()),
                kernels_more=int((k > o).sum()),
                op_path_more=int((k < o).sum()),
                same=int((k == o).sum()),
                chi2_rel_gap_max=float(max(gap)),
                chi2_rel_gap_median=float(np.median(gap)),
                by_tick=ticks)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "results",
                                                  "lm_dense.json"))
    ap.add_argument("--cells", nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--skip-kernels", action="store_true",
                    help="only the --cells part")
    args = ap.parse_args()

    import torch

    from mrg_slam_tpu_torch.config import OptimizerConfig
    from mrg_slam_tpu_torch.graph import lm_dense, solve
    from mrg_slam_tpu_torch.runtime import resolve_device

    if not torch.cuda.is_available():
        print("time_lm_dense: no CUDA card", file=sys.stderr)
        return 1
    dev = resolve_device()
    cfg = OptimizerConfig(solver_backend="dense",
                          g2o_solver_num_iterations=64)
    out = {"card": card_line(), "torch": torch.__version__, "rows": [],
           "cells": []}
    for cap_n, cap_e in ((128, 512), (256, 1024)) * (not args.skip_kernels):
        gs = ring(cap_n, cap_e, dev)
        snap, idx = gs._snapshot()
        solve.optimize(snap, cfg, index=idx)  # builds and warms
        res = solve.optimize(snap, cfg, index=idx)
        assert res.fused
        passes = res.iterations
        by, ops, dev_ms, wall = profiled(
            torch, lambda: solve.optimize(snap, cfg, index=idx))
        op_path_iterations(torch, snap, cfg, 2)  # warm
        by_op, ops_op, dev_op, wall_op = profiled(
            torch, lambda: op_path_iterations(torch, snap, cfg, passes))

        # each kernel alone, and its plain twin's stage
        b = lm_dense._batch([snap], lm_dense._stack_index([idx]),
                            cfg.lm_initial_lambda)
        lm_dense.linearize_cuda(b)
        lm_dense.assemble_cuda(b, init=True)
        y, dy, info = lm_dense._solve_step(b)
        poses0 = b.poses.clone()
        state0 = b.state.clone()

        def reset():
            b.poses.copy_(poses0)
            b.state.copy_(state0)
            b.flags[0].zero_()

        lam = torch.full((), cfg.lm_initial_lambda, device=dev)
        pl = lm_dense.assemble_plain(snap, lam)
        yy = torch.nn.functional.pad((y + dy)[0, :, 0],
                                     (0, 6 * (cap_n - idx.live)))
        n_live = int(gs.num_nodes)
        e_live = int(gs.num_edges)
        bound = bounds_ms(idx, cap_n, n_live, e_live)
        kernels = {
            "lm_linearize": (lambda: lm_dense.linearize_cuda(b), None),
            "lm_assemble": (lambda: lm_dense.assemble_cuda(b, init=False),
                            None),
            "lm_trial": (
                lambda: lm_dense.trial_cuda(b, y, dy, info, True,
                                            cfg.chi2_rel_tol), reset),
        }
        plain = {
            "lm_linearize": lambda: lm_dense.assemble_plain(snap, lam),
            "lm_trial": lambda: lm_dense.trial_plain(
                snap, yy, pl["s"], pl["diag"], pl["b"], pl["chi2"], lam,
                torch.full_like(lam, 2.0), True, cfg.chi2_rel_tol),
        }
        launches = {"lm_linearize": lm_dense.linearize_cuda.launches,
                    "lm_assemble": lm_dense.assemble_cuda.launches,
                    "lm_trial": lm_dense.trial_cuda.launches}
        for name, (fn, before) in kernels.items():
            dev_k = [v for k, v in by.items() if name + "_kernel" in k]
            row = dict(
                name=f"{name}_{cap_n}", shape=[cap_n, cap_e, n_live,
                                               e_live],
                ms=event_ms(torch, fn, before=before),
                device_ms=(dev_k[0][0] / dev_k[0][1] / 1e3 if dev_k
                           else None),
                launches_in_solve=(dev_k[0][1] if dev_k else 0),
                launches_process=launches[name],
                bound_ms=bound[name][0], bound_by=bound[name][1])
            if name in plain:
                row["plain_ms"] = event_ms(torch, plain[name])
            out["rows"].append(row)
        out["rows"].append(dict(
            name=f"lm_iteration_{cap_n}", passes=passes,
            kernels_device_ops=ops / passes,
            kernels_device_ms=dev_ms / passes,
            kernels_host_ms=wall / passes,
            op_path_device_ops=ops_op / passes,
            op_path_device_ms=dev_op / passes,
            op_path_host_ms=wall_op / passes,
            top_ops=sorted(((k, v[0] / passes / 1e3, v[1] / passes)
                            for k, v in by.items()),
                           key=lambda r: -r[1])[:12]))
    for name in args.cells:
        out["cells"].append(both_paths(torch, name, args.seed, dev))
        print(json.dumps({k: v for k, v in out["cells"][-1].items()
                          if k != "by_tick"}), flush=True)
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
