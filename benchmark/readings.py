"""The readings the limits of `correct` are set from, many seeds in one
process.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 [--control]

Per seed: the first episode of the seed's pool (its own world and scans),
through the port (the window's own calls at the cell's sizes), judged
against the plain reference; with --control, the control (the reference
in float32 with TF32 matmuls, in the program's place) judged on the same
episode. One JSON line a seed. Needs a CUDA card.
"""

import argparse
import json
import sys
import time

import torch

from . import run, system, traffic
from .reference import judge


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell = {w["name"]: w for w in run.load_spec()["workloads"]}[
        args.workload]
    cfg = run.load_config(cell["config"])
    mix = traffic.load_mix(cell["traffic"])
    dev = torch.device("cuda")
    sys_ = system.System(cfg, dev)
    wins = traffic.windows(mix)
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = traffic.make_pool(cfg, mix, dev, seed, episodes=1)
        runs, wall, _ = run.window(sys_, pool, wins, 0.0, system.Spans(),
                                   episodes=1)
        ep = runs[0]
        out = system.outputs(sys_, ep, wins)
        t0 = time.perf_counter()
        nums, det = judge.judge(cfg, ep.episode, out, dev, seed)
        line = {"seed": seed, "frames_per_s": ep.blocks * sys_.B * sys_.R
                / wall, "program": nums, "details": det,
                "reference_s": time.perf_counter() - t0}
        if args.control:
            t0 = time.perf_counter()
            line["control"], line["control_details"] = judge.judge(
                cfg, ep.episode, out, dev, seed, control=True)
            line["control_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del runs, ep, out, pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
