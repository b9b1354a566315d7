"""ATE, RPE, loops and keyframes of the JAX package on acceptance row 2
with the voxel registration family, the numbers the PyTorch port's
`chip_smoke.py` (voxel phase) holds its runs to.

Runs the JAX package's own `pipeline.replay.replay` (per frame) over row
2's frames at its width (`baseline_runs._base_cfg()`: 8192 raw -> 1024
filtered points; `_world()`, seed 21; 120 frames over 1.25 laps; a tick
every 20), once per method, with `registration_method` set to FAST_VGICP
and to NDT in both the odometry's and the back end's registration (the
default voxel resolution 1.0 and DIRECT7 search). Keyframes are the back
end's.

    python tools/voxel_reference.py

Prints one JSON line per run, then the dict that `chip_smoke.py` keeps as
`REF_VOXEL`. Runs on the CPU; expect several minutes.
"""

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from mrg_slam_tpu.io.synthetic import circle_trajectory  # noqa: E402
from mrg_slam_tpu.pipeline import baseline_runs as bl  # noqa: E402
from mrg_slam_tpu.pipeline.replay import Robot, replay  # noqa: E402

METHODS = ("FAST_VGICP", "NDT")


def voxel_cfg(method):
    """Row 2's config with `method` in the odometry and the back end."""
    cfg = bl._base_cfg()
    reg = dataclasses.replace(cfg.odometry.registration,
                              registration_method=method)
    return dataclasses.replace(
        cfg, odometry=dataclasses.replace(cfg.odometry, registration=reg),
        slam=dataclasses.replace(cfg.slam, registration=reg))


def row(method, n=120):
    world = bl._world()
    traj = circle_trajectory(n, radius=14.0, laps=1.25)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    robot = Robot(voxel_cfg(method))
    t0 = time.perf_counter()
    res = replay(robot, frames, tick_every=20, gt_xyz=traj[:, :3])
    return dict(ate_m=res.ate, rpe_m=res.rpe, loops=res.num_loops,
                keyframes=len(robot.slam.trajectory()), frames=n,
                seconds=time.perf_counter() - t0)


def main():
    t0 = time.perf_counter()
    ref = {}
    for method in METHODS:
        r = row(method)
        name = f"2_full_graph_slam_{method}"
        print(json.dumps(dict(config=name, device="cpu", **r)), flush=True)
        ref[method] = {k: v for k, v in r.items()
                       if k in ("ate_m", "rpe_m", "loops", "keyframes")}
    print(json.dumps({"REF_VOXEL": ref,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
