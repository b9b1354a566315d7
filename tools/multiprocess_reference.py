"""The JAX package's process-per-robot run on the CPU, with the numbers
the PyTorch port's `chip_smoke.py` (processes phase) and
`tests/test_torch_multiprocess.py` hold `run_multiprocess` to.

Runs the JAX package's own `pipeline/multiprocess.run_multiprocess`
(one OS process per robot over overlapping windows of the synthetic
circle, world seed 11, `_default_cfg()`: 8192 raw -> 1024 filtered
points, delta graphs over TCP in the quantized wire form), unchanged,
once per robot count, and keeps each robot's result dict (frames,
keyframes, remote keyframes merged, loops, graph bytes sent and
received, ATE of its optimized keyframes, wall).

    python tools/multiprocess_reference.py --robots 2 4 --frames 80 \
        --tick-every 15 [--json FILE]

Prints one JSON line per run, then the dict keyed "R<robots>_F<frames>_T
<tick>" that `chip_smoke.py` keeps as `REF_PROC`; `--json` also merges it
into FILE (the test reads tests/data/multiprocess_reference.json). Runs on
the CPU, one process per robot; expect one to a few minutes per run.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"

from mrg_slam_tpu.pipeline.multiprocess import run_multiprocess  # noqa: E402

KEYS = ("frames", "keyframes", "remote_keyframes", "loops",
        "received_bytes", "sent_bytes", "ate_m", "wall_s")


def key(robots, frames, tick_every):
    return f"R{robots}_F{frames}_T{tick_every}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--robots", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--tick-every", type=int, default=15)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = {}
    for r in args.robots:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res = run_multiprocess(n_robots=r, total_frames=args.frames,
                                   tick_every=args.tick_every,
                                   world_seed=args.seed, out_dir=tmp)
            wall = time.perf_counter() - t0
        k = key(r, args.frames, args.tick_every)
        out[k] = {name: {f: v[f] for f in KEYS} for name, v in res.items()}
        print(json.dumps({"run": k, "seed": args.seed, "wall_s": wall,
                          "robots": out[k]}), flush=True)
    if args.json:
        try:
            with open(args.json) as f:
                merged = json.load(f)
        except (OSError, json.JSONDecodeError):
            merged = {}
        merged.update(out)
        with open(args.json, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
            f.write("\n")
    print("REF_PROC = " + json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
