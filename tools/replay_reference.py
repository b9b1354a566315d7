"""ATE, RPE, loops and keyframes of the JAX package on acceptance rows 1, 2
and 7 and on row 1's kNN/STATISTICAL variant.

Runs the JAX package's own drives of `pipeline/baseline_runs.py` at the
rows' width (8192 raw -> 1024 filtered points, `_base_cfg()`, `_world()`):

- `1_odometry_only`: 120 frames of per-frame `ScanMatchingOdometry`, and
  `1_odometry_only_fused`, the same frames through `odometry_fused` in
  24-frame blocks (baseline_runs.py:74-130);
- `2_full_graph_slam` and `2_full_graph_slam_fused`: `replay` and
  `replay_fused` over 120 frames, a tick every 20 (:133-146);
- `7_dynamic_objects`: `replay` through 6 moving occluders, 110 frames
  (:292-310);
- `1_odometry_only_knn_statistical`: row 1 with kNN covariances
  (`reg_covariance_mode="knn"`, k = `reg_correspondence_randomness` = 10)
  and STATISTICAL outlier removal (mean_k 30, stddev 1.2).

Prints one JSON line per row, then the dict that the PyTorch port's
`chip_smoke.py` keeps as `REF_REPLAY`. Keyframes are the odometry's
keyframe switches on the odometry rows and the back end's keyframes on the
SLAM rows.

    python tools/replay_reference.py

Runs on the CPU; expect a few minutes.
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mrg_slam_tpu.io.synthetic import circle_trajectory  # noqa: E402
from mrg_slam_tpu.models import odometry_fused  # noqa: E402
from mrg_slam_tpu.models.odometry import ScanMatchingOdometry  # noqa: E402
from mrg_slam_tpu.ops.cloud import PointCloud  # noqa: E402
from mrg_slam_tpu.ops.prefilter import prefilter  # noqa: E402
from mrg_slam_tpu.pipeline import baseline_runs as bl  # noqa: E402
from mrg_slam_tpu.pipeline.replay import (Robot, replay,  # noqa: E402
                                          replay_fused)
from mrg_slam_tpu.utils.metrics import ate_rmse, rpe_rmse  # noqa: E402


def knn_statistical_cfg():
    cfg = bl._base_cfg()
    odo, slam = cfg.odometry, cfg.slam
    return dataclasses.replace(
        cfg,
        prefilter=dataclasses.replace(cfg.prefilter,
                                      outlier_removal_method="STATISTICAL"),
        odometry=dataclasses.replace(odo, registration=dataclasses.replace(
            odo.registration, reg_covariance_mode="knn")),
        slam=dataclasses.replace(slam, registration=dataclasses.replace(
            slam.registration, reg_covariance_mode="knn")))


def odometry_row(cfg, fused, n_frames=120):
    """baseline_runs.config1_odometry_only, keeping the keyframe flags."""
    world = bl._world()
    traj = circle_trajectory(n_frames, radius=14.0, laps=1.1)
    scans = [world.scan(p, seed=i) for i, p in enumerate(traj)]
    t0 = time.perf_counter()
    if fused:
        block = 24
        pre_cfg = cfg.prefilter
        pre = jax.jit(jax.vmap(lambda p, m: prefilter(PointCloud(p, m),
                                                      pre_cfg)))
        raw = np.full((n_frames, 8192, 3), 1.0e6, np.float32)
        rmask = np.zeros((n_frames, 8192), bool)
        for i, s in enumerate(scans):
            raw[i, :len(s)] = s[:8192]
            rmask[i, :len(s)] = True
        stamps = jnp.arange(n_frames, dtype=jnp.float32) * 0.1
        carry = odometry_fused.init_carry(pre_cfg.capacity_filtered_points)
        est, kfs = [], 0
        for s in range(0, n_frames, block):
            out = pre(jnp.asarray(raw[s:s + block]),
                      jnp.asarray(rmask[s:s + block]))
            carry, outs = odometry_fused.run_batch(
                cfg.odometry, carry, out.points, out.mask,
                stamps[s:s + block])
            est.append(np.asarray(outs.pose))
            kfs += int(np.asarray(outs.is_new_keyframe).sum())
        est = np.concatenate(est)
    else:
        odom = ScanMatchingOdometry(cfg.odometry)
        est, kfs = [], 0
        for i, scan in enumerate(scans):
            pc = prefilter(PointCloud.from_array(scan, capacity=8192),
                           cfg.prefilter)
            out = odom.step(pc, stamp=i * 0.1)
            est.append(out.pose)
            kfs += int(out.is_new_keyframe)
        est = np.stack(est)
    return dict(ate_m=ate_rmse(est[:, :3], traj[:, :3]),
                rpe_m=rpe_rmse(est[:, :3], traj[:, :3]), keyframes=kfs,
                frames=n_frames, seconds=time.perf_counter() - t0)


def slam_row(fused, dynamic):
    """baseline_runs.config2_full_slam / config7_dynamic_world, keeping the
    robot."""
    cfg = bl._base_cfg()
    if dynamic:
        n, world = 110, bl._world(seed=23, n_dynamic=6)
        traj = circle_trajectory(n, radius=13.0, laps=1.2)
        frames = [(i * 0.1, world.scan(p, seed=i, t=i * 0.1))
                  for i, p in enumerate(traj)]
    else:
        n, world = 120, bl._world()
        traj = circle_trajectory(n, radius=14.0, laps=1.25)
        frames = [(i * 0.1, world.scan(p, seed=i))
                  for i, p in enumerate(traj)]
    robot = Robot(cfg)
    t0 = time.perf_counter()
    res = (replay_fused if fused else replay)(robot, frames, tick_every=20,
                                              gt_xyz=traj[:, :3])
    return dict(ate_m=res.ate, rpe_m=res.rpe, loops=res.num_loops,
                keyframes=len(robot.slam.trajectory()), frames=n,
                seconds=time.perf_counter() - t0)


def main():
    t0 = time.perf_counter()
    rows = {
        "1_odometry_only": lambda: odometry_row(bl._base_cfg(), False),
        "1_odometry_only_fused": lambda: odometry_row(bl._base_cfg(), True),
        "2_full_graph_slam": lambda: slam_row(False, False),
        "2_full_graph_slam_fused": lambda: slam_row(True, False),
        "7_dynamic_objects": lambda: slam_row(False, True),
        "1_odometry_only_knn_statistical": lambda: odometry_row(
            knn_statistical_cfg(), False),
    }
    ref = {}
    for name, run in rows.items():
        r = run()
        print(json.dumps(dict(config=name, device="cpu", **r)), flush=True)
        ref[name] = {k: v for k, v in r.items()
                     if k in ("ate_m", "rpe_m", "loops", "keyframes")}
    print(json.dumps({"REF_REPLAY": ref,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
