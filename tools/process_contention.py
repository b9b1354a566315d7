"""Robot processes sharing one CUDA card, without the exchange: the
per-frame step time of N independent robot processes launched together.

Each process builds the world of `pipeline.multiprocess` (seed 11,
`_default_cfg()`: 8192 raw -> 1024 filtered points), warms a `Robot` on
4 frames, waits until all N are ready, then steps 32 frames with a
synchronize after each and prints the median and mean ms a frame. The
processes share nothing but the card (each its own CUDA context), so the
numbers show what the card's time-slicing of N contexts costs a frame,
apart from the lock-step pacing of `run_multiprocess`.

    python tools/process_contention.py [--robots 1 2 4]

Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, WARM = 32, 4


def robot(ready, go, threads):
    """One process: a robot stepping FRAMES frames once `go` exists."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from mrg_slam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 circle_trajectory)
    from mrg_slam_tpu_torch.pipeline.multiprocess import _default_cfg
    from mrg_slam_tpu_torch.pipeline.replay import Robot

    torch.set_num_threads(threads)
    world = SyntheticWorld.build(seed=11, extent=30.0, n_ground=25000,
                                 max_points_per_scan=8192, noise=0.02)
    traj = circle_trajectory(80, radius=12.0, laps=1.1)
    r = Robot(_default_cfg("alpha", ["alpha"], (0.0,) * 6))
    scans = [world.scan(traj[i], seed=i) for i in range(WARM + FRAMES)]
    for i in range(WARM):
        r.step(i * 0.1, scans[i])
    torch.cuda.synchronize()
    open(ready, "w").close()
    while not os.path.exists(go):
        time.sleep(0.002)
    ms = []
    for i in range(WARM, WARM + FRAMES):
        t0 = time.perf_counter()
        r.step(i * 0.1, scans[i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"median_ms": float(np.median(ms)),
                      "mean_ms": float(np.mean(ms))}))


def run(n):
    """N robot processes at once -> their reports."""
    with tempfile.TemporaryDirectory() as tmp:
        go = os.path.join(tmp, "go")
        threads = max(1, (os.cpu_count() or 1) // n)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--robot",
             os.path.join(tmp, f"{k}.ready"), go, str(threads)],
            stdout=subprocess.PIPE, text=True) for k in range(n)]
        try:
            deadline = time.time() + 300.0
            while sum(f.endswith(".ready") for f in os.listdir(tmp)) < n:
                if time.time() > deadline or any(
                        p.poll() not in (None, 0) for p in procs):
                    raise RuntimeError("a robot process did not get ready")
                time.sleep(0.01)
            open(go, "w").close()
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError("a robot process failed")
        return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def main(argv=None):
    if argv is None and sys.argv[1:2] == ["--robot"]:
        return robot(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--robots", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"# {card}")
    for n in args.robots:
        reps = run(n)
        print(f"# {n} independent robot processes, per-frame step ms "
              f"(median, mean): "
              + ", ".join(f"{r['median_ms']:.2f} / {r['mean_ms']:.2f}"
                          for r in reps), flush=True)


if __name__ == "__main__":
    main()
