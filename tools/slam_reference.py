"""Full-SLAM ATE, keyframes and loops of the JAX package on the bench world.

Runs bench.py's `run_full_slam` (bench.py:200-223) on the first FRAMES
frames of bench.py's production world and configs (131072 raw points,
8192 filtered, keyframe_delta 1.1 m, stores starting at 128 keyframes and
512 edges): per 32-frame block the reference prefilter and fused odometry,
`MrgSlam.process_scan` per frame with the front end's covariances, and
one `MrgSlam.optimization_tick`. Prints ATE after SLAM, ATE of odometry
alone (both Umeyama-aligned at the keyframes' stamps, as bench.py does),
keyframes and loops as one JSON line. The PyTorch port's `chip_smoke.py`
holds its full-SLAM phase to these numbers (`REF_SLAM` there).

    python tools/slam_reference.py [--frames 320]

Runs on the CPU; expect tens of minutes at full width.
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
from mrg_slam_tpu.models.backend import MrgSlam  # noqa: E402
from mrg_slam_tpu.ops import registration as reg  # noqa: E402
from mrg_slam_tpu.ops.cloud import PointCloud  # noqa: E402
from mrg_slam_tpu.ops.prefilter import prefilter  # noqa: E402
from mrg_slam_tpu.utils.metrics import ate_rmse  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=320)
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
    pre_cfg, odo_cfg, slam_cfg = make_configs(
        RAW, FILTERED, keyframe_delta=1.1, capacity_keyframes=128,
        capacity_edges=512)
    covs_ok = reg.covariance_compatible(odo_cfg.registration,
                                        slam_cfg.registration)

    @jax.jit
    def prefilter_batch(pts, masks):
        out = jax.vmap(lambda p, m: prefilter(PointCloud(p, m), pre_cfg)
                       )(pts, masks)
        return out.points, out.mask

    slam = MrgSlam(slam_cfg)
    carry = fused.init_carry(FILTERED)
    ticks = []
    for s in range(0, args.frames, BLOCK):
        e = min(s + BLOCK, args.frames)
        fpts, fmask = prefilter_batch(jnp.asarray(raw[s:e]),
                                      jnp.asarray(rmask[s:e]))
        stamps = jnp.arange(s, e, dtype=jnp.float32) * 0.1
        carry, outs = fused.run_batch(odo_cfg, carry, fpts, fmask, stamps)
        poses = np.asarray(outs.pose)
        for i in range(poses.shape[0]):
            slam.process_scan((s + i) * 0.1, poses[i],
                              PointCloud(fpts[i], fmask[i]),
                              source_covs=outs.covs[i] if covs_ok else None)
        st = slam.optimization_tick(now=e * 0.1)
        ticks.append(dict(loops=st.num_loops, lm_iterations=st.iterations,
                          chi2_before=st.chi2_before,
                          chi2_after=st.chi2_after))
        print(json.dumps({"block": s // BLOCK, **ticks[-1],
                          "seconds": time.perf_counter() - t0}),
              file=sys.stderr, flush=True)

    own = sorted(slam.db.own_keyframes(), key=lambda k: k.stamp)
    idx = [int(round(k.stamp / 0.1)) for k in own]
    ate = ate_rmse(slam.trajectory()[:, :3], traj[idx][:, :3])
    odo = np.stack([k.odom for k in own])
    print(json.dumps({
        "frames": args.frames, "ate_m": ate,
        "ate_odom_m": ate_rmse(odo[:, :3], traj[idx][:, :3]),
        "keyframes": len(slam.db.keyframes) + len(slam.db.new_keyframes),
        "loops": sum(1 for e in slam.db.edges if e.type == "loop"),
        "ticks": ticks, "device": "cpu",
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
