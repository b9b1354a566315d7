"""Shared-graph co-hosting of the JAX package on bench's multi-robot world.

Runs the drive of bench.py's `run_multirobot_scaling` (bench.py:277-475)
once per fleet size R = 2, 3, 4 on the CPU: bench's MR world
(`build_world_and_scans(n_frames=160, laps=1.0)`, 32768 raw points, 4096
filtered) and its multi-robot config overrides, the fixed 240-scan survey
split among R robots (`windows_for`), and per block of B frames one
prefilter over the R*B raw scans, one `run_batch_multi`, one
`SharedGraphSlam.process_scan` per robot and frame and one
`optimization_tick`, then a final tick. The body of bench's nested `run`
is copied here unchanged in what it computes.

Prints, per R, one JSON line: per-robot keyframe ATE (Umeyama-aligned at
the keyframe stamps, as bench.py:450-455 does), the worst of them, the
ATE of odometry alone at the same keyframes, per-robot keyframes,
inter-robot and all loops. The PyTorch port's
`chip_smoke.py` holds its multi-robot phase to these numbers (`REF_MR`
there).

    python tools/shared_graph_reference.py [--robots 2 3 4]

Runs on the CPU; expect tens of minutes.
"""

import argparse
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

from bench import (MR_FILTERED, MR_FRAMES, MR_RAW,  # noqa: E402
                   build_world_and_scans, make_configs, stack_scans)
from mrg_slam_tpu.models import odometry_fused as fused  # noqa: E402
from mrg_slam_tpu.models.shared_graph import SharedGraphSlam  # noqa: E402
from mrg_slam_tpu.ops import registration as reg  # noqa: E402
from mrg_slam_tpu.ops.cloud import PointCloud  # noqa: E402
from mrg_slam_tpu.ops.prefilter import prefilter  # noqa: E402
from mrg_slam_tpu.utils.metrics import ate_rmse  # noqa: E402

BLOCKS = {2: 24, 3: 16, 4: 12}  # bench.py's B per fleet size


def mr_configs():
    """make_configs(MR_RAW, MR_FILTERED) with bench.py:309-326's
    multi-robot overrides."""
    pre_cfg, odo_cfg, slam_cfg = make_configs(MR_RAW, MR_FILTERED)
    odo_cfg = dataclasses.replace(
        odo_cfg, keyframe_delta_translation=2.0,
        registration=dataclasses.replace(odo_cfg.registration,
                                         reg_transformation_epsilon=1e-3))
    slam_cfg = dataclasses.replace(
        slam_cfg,
        loop=dataclasses.replace(slam_cfg.loop,
                                 accum_distance_thresh_other_robot=2.0,
                                 capacity_candidates=2),
        registration=dataclasses.replace(slam_cfg.registration,
                                         reg_maximum_iterations=12))
    return pre_cfg, odo_cfg, slam_cfg


def init_pose_of(p):
    yaw = 2.0 * np.arctan2(p[6], p[3])
    return (float(p[0]), float(p[1]), float(p[2]), float(yaw), 0.0, 0.0)


def windows_for(R):
    """bench.py:341-361: the fixed 240-scan survey split among R robots."""
    names = ["alpha", "bravo", "charlie", "delta"][:R]
    span = 240 // R
    stride = (MR_FRAMES - span) // (R - 1)
    w = [(i * stride, i * stride + span) for i in range(R - 1)]
    w.append((MR_FRAMES - span, MR_FRAMES))
    return dict(zip(names, w))


def run(R, traj, raw_d, rmask_d, cfgs):
    pre_cfg, odo_cfg, slam_cfg = cfgs
    stamps = jnp.arange(MR_FRAMES, dtype=jnp.float32) * 0.1
    covs_ok = reg.covariance_compatible(odo_cfg.registration,
                                        slam_cfg.registration)

    @jax.jit
    def prefilter_batch(pts, masks):
        out = jax.vmap(lambda p, m: prefilter(PointCloud(p, m), pre_cfg)
                       )(pts, masks)
        return out.points, out.mask

    windows = windows_for(R)
    names = list(windows)
    B = BLOCKS[R]
    group = SharedGraphSlam(
        dataclasses.replace(slam_cfg, own_name=names[0],
                            multi_robot_names=tuple(names)),
        names, {name: init_pose_of(np.asarray(traj[lo]))
                for name, (lo, _) in windows.items()})
    carries = jax.tree.map(lambda *x: jnp.stack(x),
                           *[fused.init_carry(MR_FILTERED) for _ in names])

    def ingest(name, s, fpts, fmask, poses, covs=None):
        for i in range(poses.shape[0]):
            group.process_scan(name, (s + i) * 0.1, poses[i],
                               PointCloud(fpts[i], fmask[i]),
                               source_covs=(covs[i] if covs is not None
                                            else None))

    ticks = []
    n_local = max(hi - lo for lo, hi in windows.values())
    for s in range(0, n_local, B):
        spans = {n: (windows[n][0] + s,
                     min(windows[n][0] + s + B, windows[n][1]))
                 for n in names if s < windows[n][1] - windows[n][0]}
        if (len(spans) == len(names)
                and all(b - a == B for a, b in spans.values())):
            fpts, fmask = prefilter_batch(
                jnp.concatenate([raw_d[a:b] for a, b in spans.values()]),
                jnp.concatenate([rmask_d[a:b] for a, b in spans.values()]))
            fpts = fpts.reshape(R, B, *fpts.shape[1:])
            fmask = fmask.reshape(R, B, *fmask.shape[1:])
            st2 = jnp.broadcast_to(stamps[s:s + B], (R, B))
            carries, outs = fused.run_batch_multi(odo_cfg, carries, fpts,
                                                  fmask, st2)
            all_poses = np.asarray(outs.pose)
            for r, name in enumerate(names):
                ingest(name, s, fpts[r], fmask[r], all_poses[r],
                       covs=(outs.covs[r] if covs_ok else None))
        else:
            for r, name in enumerate(names):
                if name not in spans:
                    continue
                a, b = spans[name]
                fpts, fmask = prefilter_batch(raw_d[a:b], rmask_d[a:b])
                c_r = jax.tree.map(lambda x: x[r], carries)
                c_r, outs = fused.run_batch(odo_cfg, c_r, fpts, fmask,
                                            stamps[s:s + (b - a)])
                carries = jax.tree.map(lambda f, v: f.at[r].set(v),
                                       carries, c_r)
                ingest(name, s, fpts, fmask, np.asarray(outs.pose),
                       covs=(outs.covs if covs_ok else None))
        st = group.optimization_tick(now=(s + B) * 0.1)
        ticks.append(dict(loops=st.num_loops, lm_iterations=st.iterations,
                          chi2_after=st.chi2_after))
    st = group.optimization_tick(now=n_local * 0.1)
    if st is not None:
        ticks.append(dict(loops=st.num_loops, lm_iterations=st.iterations,
                          chi2_after=st.chi2_after))
    return group, windows, ticks


def metrics(group, windows, traj):
    """bench.py:450-462: per-robot keyframe ATE (and that of odometry
    alone at the same keyframes), keyframes, and loops."""
    ates, odo_ates, kfs = {}, {}, {}
    for name, (lo, _) in windows.items():
        own = sorted(group.robot_keyframes(name), key=lambda k: k.stamp)
        est = np.stack([k.estimate(group.db.graph) for k in own])
        gt = np.asarray(traj[[lo + int(round(k.stamp / 0.1)) for k in own]])
        ates[name] = float(ate_rmse(est[:, :3], gt[:, :3]))
        odo = np.stack([k.odom for k in own])
        odo_ates[name] = float(ate_rmse(odo[:, :3], gt[:, :3]))
        kfs[name] = len(own)
    loops = inter = 0
    for e in group.db.edges:
        if e.type != "loop":
            continue
        a = group.db.uuid_keyframe_map[e.from_uuid]
        b = group.db.uuid_keyframe_map[e.to_uuid]
        loops += 1
        inter += a.robot_name != b.robot_name
    return dict(ate_m=ates, worst_ate_m=max(ates.values()),
                ate_odom_m=odo_ates, keyframes=kfs, inter_loops=inter,
                loops=loops)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--robots", type=int, nargs="+", default=[2, 3, 4])
    args = ap.parse_args()
    t0 = time.perf_counter()
    traj, scans = build_world_and_scans(n_frames=MR_FRAMES, laps=1.0)
    raw, rmask = stack_scans(scans, MR_RAW)
    raw_d, rmask_d = jnp.asarray(raw), jnp.asarray(rmask)
    cfgs = mr_configs()
    for R in args.robots:
        t1 = time.perf_counter()
        group, windows, ticks = run(R, traj, raw_d, rmask_d, cfgs)
        print(json.dumps({"robots": R, **metrics(group, windows, traj),
                          "ticks": ticks, "device": "cpu",
                          "seconds": time.perf_counter() - t1}), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), file=sys.stderr)


if __name__ == "__main__":
    main()
