"""Front-end throughput and a device profile of the PyTorch port, on a card.

    python tools/profile_front_end.py [--passes 4] [--profile]

Builds chip_smoke.py's world and configs (bench.py's production world,
96 frames) and runs chip_smoke.front_end (prefilter -> run_batch, 32-frame
blocks) `passes` times, printing each pass's block walls and frames/s;
pass 1 warms the process. With --profile it then traces one more full
pass with torch.profiler and prints the device time per frame, the same
over the unprofiled wall per frame (median of passes 2 on; the device-busy
share), the profiled wall, kernel launches per frame, and the top ops by
device and by host time. Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (world, configs, sizes and the front end)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch

    from mrg_slam_tpu_torch.runtime import resolve_device

    frames = chip_smoke.FRAMES
    inp = chip_smoke.front_end_inputs(torch, resolve_device())
    fps, walls = [], []
    for _ in range(args.passes):
        run = chip_smoke.front_end(torch, inp)
        walls.append([round(w * 1e3, 2) for w in run.block_walls])
        fps.append(frames / sum(run.block_walls))
    out = {"card": chip_smoke.card_line(), "frames_per_s": fps,
           "block_walls_ms": walls}
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
