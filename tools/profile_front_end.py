"""Front-end throughput and a device profile of the PyTorch port, on a card.

    python tools/profile_front_end.py [--passes 4] [--profile]
        [--tree DIR] [--poses FILE] [--same-as FILE]

Builds chip_smoke.py's world and configs (bench.py's production world,
96 frames) and runs chip_smoke.front_end (prefilter -> run_batch, 32-frame
blocks) `passes` times, printing each pass's block walls and frames/s;
pass 1 warms the process. With --profile it then traces one more full
pass with torch.profiler and prints the device time per frame, the same
over the unprofiled wall per frame (median of passes 2 on; the device-busy
share), the profiled wall, kernel launches per frame, and the top ops by
device and by host time. Needs a CUDA card.

--tree runs the chip_smoke.py and mrg_slam_tpu_torch of another checkout
(an unpacked `git archive` of an earlier commit), so that two versions
run in turns on one card; --poses saves pass 1's poses (.npy) for a
bitwise comparison between them, and --same-as FILE reports whether pass
1's poses equal, bit for bit, those saved in FILE by another run.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--poses")
    ap.add_argument("--same-as")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    import chip_smoke  # world, configs, sizes and the front end
    from mrg_slam_tpu_torch.ops import nn_kernel
    from mrg_slam_tpu_torch.runtime import resolve_device

    frames = chip_smoke.FRAMES
    inp = chip_smoke.front_end_inputs(torch, resolve_device())
    fps, walls = [], []
    for i in range(args.passes):
        nn_kernel.nn_cuda.launches = 0
        run = chip_smoke.front_end(torch, inp)
        walls.append([round(w * 1e3, 2) for w in run.block_walls])
        fps.append(frames / sum(run.block_walls))
        if i == 0:
            nn_launches = nn_kernel.nn_cuda.launches
            gn_iters = int(run.iterations.sum())
            poses = run.poses.cpu().numpy()
            if args.poses:
                np.save(args.poses, poses)
    out = {"card": chip_smoke.card_line(), "tree": os.path.abspath(args.tree),
           "frames_per_s": fps, "block_walls_ms": walls,
           "gn_iterations": gn_iters, "nn_launches": nn_launches}
    if args.same_as:
        ref = np.load(args.same_as)
        out["poses_bitwise_same_as"] = {
            "file": args.same_as, "same": bool(
                ref.shape == poses.shape
                and (ref.view(np.uint32) == poses.view(np.uint32)).all())}
    wall_ms = 1e3 / float(np.median(fps[1:] or fps))

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chip_smoke.front_end(torch, inp)
            prof_wall = time.perf_counter() - t0
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
        out.update(device_ms_per_frame=busy_ms / frames,
                   wall_ms_per_frame=wall_ms,
                   device_busy_share=busy_ms / frames / wall_ms,
                   profiled_wall_ms_per_frame=prof_wall * 1e3 / frames,
                   device_launches_per_frame=len(device) / frames)
        avg = prof.key_averages()
        print(avg.table(sort_by="self_device_time_total", row_limit=15))
        print(avg.table(sort_by="self_cpu_time_total", row_limit=15))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
