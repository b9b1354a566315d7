"""Solve times of bench.py's solver section through the PyTorch port, on a card.

    python tools/time_solvers.py [--tree DIR]

Times the four solves of chip_smoke.py's solver phase with its own
functions (`solver_graph`, `timed_solve`: a warm call, then the median of
three calls on perturbed poses, each ending in a synchronize): row 5's cg
solve on `build_ring_graph(256)` (40 LM iterations), and dense at 1024,
chain at 1024 and chain at 8192 nodes on bench's ring with its Huber
chords (64 LM iterations). Prints one JSON line: the card's name and
power limit, the tree, and each solve's ms, rep ms, LM and CG iterations
and final chi2. The solvers run no hand-written kernel, so nothing is
built. Needs a CUDA card.

--tree runs the chip_smoke.py and mrg_slam_tpu_torch of another checkout
(an unpacked `git archive` of an earlier commit), so that two versions
run in turns on one card.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    import chip_smoke  # the solver graphs and the timing
    from mrg_slam_tpu_torch.pipeline.baseline_runs import build_ring_graph
    from mrg_slam_tpu_torch.runtime import resolve_device

    if not torch.cuda.is_available():
        print("time_solvers: no CUDA card", file=sys.stderr)
        return 1
    dev = resolve_device()
    runs = [("cg_256", build_ring_graph(256, device=dev).snapshot(), "cg",
             40)]
    for n, backend in ((1024, "dense"), (1024, "chain"), (8192, "chain")):
        runs.append((f"{backend}_{n}",
                     chip_smoke.solver_graph(n, backend, dev).snapshot(),
                     backend, chip_smoke.SOLVER_ITERS))
    out = {"card": chip_smoke.card_line(), "tree": os.path.abspath(args.tree)}
    for name, g, backend, iters in runs:
        m, _ = chip_smoke.timed_solve(torch, g, backend, iters, name)
        out[name] = m
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
