"""Odometry ATE of the JAX package's front end on the bench world.

Runs the reference front end (`prefilter` -> `odometry_fused.run_batch`)
on the first FRAMES frames of bench.py's production world and configs, and
prints the Umeyama-aligned ATE against ground truth as one JSON line. The
PyTorch port's `chip_smoke.py` holds its own ATE on the same frames to this
number (`REF_ATE_M` there).

    python tools/front_end_reference.py [--frames 96]

Runs on the CPU; expect a few minutes at full width (131072 raw points,
8192 filtered).
"""

import argparse
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

from bench import (BLOCK, FILTERED, N_FRAMES, RAW,  # noqa: E402
                   make_configs, stack_scans)
from mrg_slam_tpu.io.synthetic import (SyntheticWorld,  # noqa: E402
                                       circle_trajectory)
from mrg_slam_tpu.models import odometry_fused as fused  # noqa: E402
from mrg_slam_tpu.ops.cloud import PointCloud  # noqa: E402
from mrg_slam_tpu.ops.prefilter import prefilter  # noqa: E402
from mrg_slam_tpu.utils.metrics import ate_rmse  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=96)
    args = ap.parse_args()
    t0 = time.perf_counter()
    # bench.py run_production's world (bench.py:166-168); the trajectory
    # keeps its 640-frame spacing and only its first `frames` are scanned
    world = SyntheticWorld.build(seed=11, extent=60.0, n_ground=400000,
                                 n_pillars=150, n_walls=40,
                                 max_points_per_scan=RAW, noise=0.02)
    traj = circle_trajectory(N_FRAMES, radius=20.0, laps=3.02)[:args.frames]
    raw, rmask = stack_scans([world.scan(p, seed=i)
                              for i, p in enumerate(traj)], RAW)
    pre_cfg, odo_cfg, _ = make_configs(RAW, FILTERED)
    pre = jax.jit(lambda p, m: prefilter(PointCloud(p, m), pre_cfg))
    carry = fused.init_carry(FILTERED)
    poses, kfs = [], 0
    for s in range(0, args.frames, BLOCK):
        clouds = [pre(jnp.asarray(raw[i]), jnp.asarray(rmask[i]))
                  for i in range(s, min(s + BLOCK, args.frames))]
        pts = jnp.stack([c.points for c in clouds])
        msk = jnp.stack([c.mask for c in clouds])
        stamps = jnp.arange(s, s + pts.shape[0], dtype=jnp.float32) * 0.1
        carry, outs = fused.run_batch(odo_cfg, carry, pts, msk, stamps)
        poses.append(np.asarray(outs.pose))
        kfs += int(np.asarray(outs.is_new_keyframe).sum())
    est = np.concatenate(poses)
    ate = ate_rmse(est[:, :3], traj[:, :3])
    print(json.dumps({"frames": args.frames, "ate_m": ate, "keyframes": kfs,
                      "device": "cpu",
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
