"""Synthetic workloads of the acceptance runs.

Counterpart of the JAX package's pipeline/baseline_runs.py. The container
carries no datasets, so the acceptance configurations run on the synthetic
world, with ground truth for ATE. Ported here:

  1. odometry only (prefilter + GICP), per frame or fused;
  2. full single-robot graph SLAM (keyframes + loops + optimization),
     through `replay` or `replay_fused`;
  3. floor-augmented SLAM (RANSAC ground plane and EdgeSE3Plane);
  4. two robots exchanging delta graphs over overlapping windows;
  6. two robots meeting head on (one window played backwards);
  7. full SLAM through moving occluders;

  5. the ring pose graph solved on one device and over eight ranks
     (`5_distributed_mesh_solve`, parallel/dist_solver.py);

the ring pose graph, the workload of the solver section and of row 5,
and a ring that carries every prior and plane family
(`family_graph_spec`, numpy, for either package's GraphSLAM). Each row runs on the card unless `device` says otherwise,
and returns the JAX package's keys plus the keyframes (rows 4 and 6: the
exchange's counts too). `main` (`python -m
mrg_slam_tpu_torch.pipeline.baseline_runs [out] [--device cpu]`) runs the
set and writes BASELINE_TORCH.json.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import (EngineConfig, LoopClosureConfig, OptimizerConfig,
                      PrefilterConfig, RegistrationConfig,
                      ScanMatchingOdometryConfig, SlamConfig)
from ..graph.builder import GraphSLAM
from ..io.synthetic import SyntheticWorld, circle_trajectory
from ..models import odometry_fused
from ..models.odometry import ScanMatchingOdometry
from ..ops.cloud import PAD_VALUE, PointCloud
from ..ops.prefilter import prefilter
from ..runtime import DeviceLike, resolve_device
from ..utils import se3, se3np
from ..utils.metrics import ate_rmse, rpe_rmse
from .replay import Robot, replay, replay_fused, replay_multirobot


def _base_cfg() -> EngineConfig:
    """The acceptance rows' configuration (baseline_runs.py:30-60 of the
    JAX package): 8192 raw -> 1024 filtered points, SMALL_GICP with radius
    covariances, 2 m keyframes, a dense LM, and the default robot names
    ("atlas", "bestla"), which gate nothing while no other robot is on the
    wire (rows 1, 2, 3, 7)."""
    reg = RegistrationConfig(reg_transformation_epsilon=1e-3,
                             reg_maximum_iterations=32,
                             reg_correspondence_randomness=10,
                             reg_covariance_radius=1.0)
    return EngineConfig(
        prefilter=PrefilterConfig(downsample_resolution=0.4,
                                  capacity_raw_points=8192,
                                  capacity_filtered_points=1024,
                                  outlier_removal_method="NONE"),
        odometry=ScanMatchingOdometryConfig(keyframe_delta_translation=2.0,
                                            registration=reg),
        slam=SlamConfig(keyframe_delta_trans=2.0, capacity_keyframes=128,
                        capacity_edges=512, capacity_keyframe_points=1024,
                        registration=reg,
                        optimizer=OptimizerConfig(
                            solver_backend="dense",
                            g2o_solver_num_iterations=64),
                        # acceptance fitness gated to the correspondence
                        # radius (the reference's fitness_score_max_range,
                        # loop_detector.cpp:156), as the JAX package's rows
                        loop=dataclasses.replace(LoopClosureConfig(),
                                                 capacity_candidates=4,
                                                 fitness_score_max_range=2.0),
                        robot_remove_points_radius=0.0))


def _world(seed=21, flat_ground=False, n_dynamic=0) -> SyntheticWorld:
    return SyntheticWorld.build(seed=seed, extent=35.0, n_ground=30000,
                                n_pillars=30, n_walls=12,
                                max_points_per_scan=8192, noise=0.02,
                                flat_ground=flat_ground,
                                n_dynamic=n_dynamic)


def config1_odometry_only(n_frames=120, fused=False,
                          cfg: Optional[EngineConfig] = None,
                          device: DeviceLike = None) -> Dict:
    """Row 1: prefilter + odometry over one lap and a tenth. Per frame
    (`ScanMatchingOdometry`), or with `fused` in 24-frame blocks (one
    prefilter and one `odometry_fused.run_batch` a block). `cfg` defaults
    to `_base_cfg()`."""
    dev = resolve_device(device)
    cfg = cfg or _base_cfg()
    world = _world()
    traj = circle_trajectory(n_frames, radius=14.0, laps=1.1)
    scans = [world.scan(p, seed=i) for i, p in enumerate(traj)]
    cap = cfg.prefilter.capacity_raw_points
    if fused:
        block = 24
        raw = np.full((n_frames, cap, 3), PAD_VALUE, np.float32)
        rmask = np.zeros((n_frames, cap), bool)
        for i, s in enumerate(scans):
            m = min(len(s), cap)
            raw[i, :m] = s[:m]
            rmask[i, :m] = True
        raw_d = torch.from_numpy(raw).to(dev)
        rmask_d = torch.from_numpy(rmask).to(dev)
        stamps = torch.arange(n_frames, dtype=torch.float32,
                              device=dev) * 0.1
        carry = odometry_fused.init_carry(
            cfg.prefilter.capacity_filtered_points, device=dev)
        est, kfs = [], 0
        t0 = time.perf_counter()
        for s in range(0, n_frames, block):
            out = prefilter(PointCloud(raw_d[s:s + block],
                                       rmask_d[s:s + block]), cfg.prefilter)
            carry, outs = odometry_fused.run_batch(
                cfg.odometry, carry, out.points, out.mask,
                stamps[s:s + block])
            est.append(outs.pose.cpu().numpy())
            kfs += int(outs.is_new_keyframe.sum())
        wall = time.perf_counter() - t0
        est = np.concatenate(est)[:n_frames]
    else:
        odom = ScanMatchingOdometry(cfg.odometry)
        est, kfs = [], 0
        t0 = time.perf_counter()
        for i, scan in enumerate(scans):
            pc = prefilter(PointCloud.from_array(scan, capacity=cap,
                                                 device=dev), cfg.prefilter)
            out = odom.step(pc, stamp=i * 0.1)
            est.append(out.pose)
            kfs += int(out.is_new_keyframe)
        wall = time.perf_counter() - t0
        est = np.stack(est)
    return {"config": "1_odometry_only" + ("_fused" if fused else ""),
            "ate_rmse": ate_rmse(est[:, :3], traj[:, :3]),
            "rpe_rmse": rpe_rmse(est[:, :3], traj[:, :3]),
            "keyframes": kfs, "frames": n_frames,
            "frames_per_s": n_frames / wall}


def _slam_row(name, frames, traj, fused, device, cfg=None) -> Dict:
    robot = Robot(cfg or _base_cfg(), device=device)
    run = replay_fused if fused else replay
    res = run(robot, frames, tick_every=20, gt_xyz=traj[:, :3])
    return {"config": name + ("_fused" if fused else ""),
            "ate_rmse": res.ate, "rpe_rmse": res.rpe,
            "loops": res.num_loops,
            "keyframes": len(res.keyframe_trajectory),
            "plane_edges": robot.slam.db.graph.num_plane_edges,
            "frames": len(frames), "frames_per_s": res.frames_per_s,
            "keyframe_trajectory": res.keyframe_trajectory}


def with_registration_method(cfg: EngineConfig, method: str
                             ) -> EngineConfig:
    """`cfg` with `method` in the odometry's and the back end's
    registration (the voxel family: FAST_VGICP, VGICP, NDT)."""
    def swap(reg):
        return dataclasses.replace(reg, registration_method=method)

    return dataclasses.replace(
        cfg, odometry=dataclasses.replace(
            cfg.odometry, registration=swap(cfg.odometry.registration)),
        slam=dataclasses.replace(cfg.slam,
                                 registration=swap(cfg.slam.registration)))


def config2_full_slam(n_frames=120, fused=False,
                      device: DeviceLike = None,
                      registration_method: Optional[str] = None) -> Dict:
    """Row 2: full SLAM over 1.25 laps, a tick every 20 frames, through
    `replay` or, with `fused`, `replay_fused`. The dict also carries the
    optimized keyframe poses. `registration_method` replaces the row's
    SMALL_GICP in the odometry and the back end (the voxel family runs
    per frame: the fused front end takes the GICP family only)."""
    world = _world()
    traj = circle_trajectory(n_frames, radius=14.0, laps=1.25)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    if registration_method is None:
        return _slam_row("2_full_graph_slam", frames, traj, fused, device)
    return _slam_row(f"2_full_graph_slam_{registration_method}", frames,
                     traj, fused, device, with_registration_method(
                         _base_cfg(), registration_method))


def floor_cfg() -> EngineConfig:
    """Row 3's configuration (baseline_runs.py:154-166 of the JAX
    package): `_base_cfg()` with floor detection (sensor height 1.5 m,
    clip range 1.0 m, 150 floor points) and the floor processor on."""
    cfg = _base_cfg()
    return dataclasses.replace(
        cfg,
        floor=dataclasses.replace(cfg.floor, enable_floor_detection=True,
                                  sensor_height=1.5, height_clip_range=1.0,
                                  floor_pts_thresh=150),
        slam=dataclasses.replace(cfg.slam, floor_coeffs=dataclasses.replace(
            cfg.slam.floor_coeffs, enable_floor_coeffs=True)))


def config3_floor_augmented(n_frames=100,
                            device: DeviceLike = None) -> Dict:
    """Row 3: full SLAM on the flat-ground world over 1.1 laps of a 12 m
    circle, a tick every 20 frames, with a floor plane fitted on every
    filtered scan and tied to its keyframe (EdgeSE3Plane to one fixed
    z = 0 plane)."""
    world = _world(flat_ground=True)
    traj = circle_trajectory(n_frames, radius=12.0, laps=1.1)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    return _slam_row("3_floor_augmented", frames, traj, False, device,
                     cfg=floor_cfg())


def config7_dynamic_world(n_frames=110, device: DeviceLike = None) -> Dict:
    """Row 7: full SLAM through 6 moving occluders, which add clusters
    that do not repeat and shadow the static structure behind them
    (io/synthetic.py `scan(t=)`); odometry and loop closure must stay
    accurate though every scan is corrupted."""
    world = _world(seed=23, n_dynamic=6)
    traj = circle_trajectory(n_frames, radius=13.0, laps=1.2)
    frames = [(i * 0.1, world.scan(p, seed=i, t=i * 0.1))
              for i, p in enumerate(traj)]
    row = _slam_row("7_dynamic_objects", frames, traj, False, device)
    row["dynamic_objects"] = 6
    return row


def _exchange_cfg() -> EngineConfig:
    """Rows 4 and 6: `_base_cfg()` with a faster exchange cadence, so that
    merges land while the overlap is fresh (baseline_runs.py:187-193 of
    the JAX package)."""
    cfg = _base_cfg()
    return dataclasses.replace(cfg, slam=dataclasses.replace(
        cfg.slam, exchange=dataclasses.replace(
            cfg.slam.exchange, graph_request_min_time_delay=0.5,
            graph_request_min_accum_dist=1.0)))


def _init_pose(p: np.ndarray) -> tuple:
    """(x, y, z, yaw, pitch, roll) of a planar pose7 (wxyz)."""
    yaw = 2.0 * np.arctan2(p[6], p[3])
    return (float(p[0]), float(p[1]), float(p[2]), float(yaw), 0.0, 0.0)


def _exchange_row(name: str, robots: Dict[str, Robot], results,
                  ates: Dict, n_frames: int) -> Dict:
    """Rows 4 and 6's dict: the JAX package's keys (ATE per robot, its
    loops, frames) and per robot its keyframes, loops, inter-robot loops,
    merged remote keyframes, graph bytes sent and received, frames run,
    frames/s, tick stats, optimized keyframe poses and pose graph."""
    out = {"config": name, "ate_rmse": ates, "frames": n_frames}
    per = {k: {} for k in ("loops", "inter_robot_loops", "keyframes",
                           "remote_keyframes", "sent_bytes",
                           "received_bytes", "robot_frames", "frames_per_s",
                           "ticks", "keyframe_trajectory", "graphs")}
    for rname, robot in robots.items():
        slam, db = robot.slam, robot.slam.db
        loops = [e for e in db.edges if e.type == "loop"]
        robot_of = {u: k.robot_name for u, k in db.uuid_keyframe_map.items()}
        per["loops"][rname] = len(loops)
        per["inter_robot_loops"][rname] = sum(
            robot_of[e.from_uuid] != robot_of[e.to_uuid] for e in loops)
        per["keyframes"][rname] = len(db.own_keyframes())
        per["remote_keyframes"][rname] = sum(
            k.robot_name != rname and k.odom_counter >= 0
            for k in db.keyframes + db.new_keyframes)
        per["sent_bytes"][rname] = int(sum(slam.sent_graph_bytes))
        per["received_bytes"][rname] = int(sum(slam.received_graph_bytes))
        per["robot_frames"][rname] = len(results[rname].stamps)
        per["frames_per_s"][rname] = results[rname].frames_per_s
        per["ticks"][rname] = slam.tick_stats
        per["keyframe_trajectory"][rname] = results[rname].\
            keyframe_trajectory
        per["graphs"][rname] = db.graph
    out.update(per)
    wall = next(iter(results.values())).wall_s
    out["frames_per_s_total"] = sum(per["robot_frames"].values()) / max(
        wall, 1e-9)
    out["wall_s"] = wall
    return out


def config4_two_robot(n_frames=100, coordinate: bool = True,
                      device: DeviceLike = None) -> Dict:
    """Row 4: two robots over overlapping windows (30 %) of one lap of a
    14 m circle, a tick every 8 rounds, exchanging delta graphs
    (baseline_runs.py:177-227 of the JAX package, its start pose and
    ground-truth offset of bestla included). ATE of each robot's
    optimized keyframes against the truth at frames spread over its
    window, as the JAX package evaluates them."""
    from .multirobot_split import run_multirobot_split

    world = _world()
    traj = circle_trajectory(n_frames, radius=14.0, laps=1.0)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    start_b = int(n_frames / 2 * (1 - 0.3))
    results, robots = run_multirobot_split(
        _exchange_cfg(), frames, ["atlas", "bestla"],
        init_poses={"atlas": _init_pose(traj[0]),
                    "bestla": _init_pose(traj[start_b])},
        overlap_fraction=0.3, tick_every=8, coordinate=coordinate,
        device=device)
    ates = {}
    offsets = {"atlas": 0, "bestla": start_b}
    for name, res in results.items():
        kf = res.keyframe_trajectory
        if not len(kf):
            ates[name] = None
            continue
        gt_idx = [min(offsets[name] + j, n_frames - 1)
                  for j in np.linspace(0, len(res.trajectory) - 1,
                                       len(kf)).astype(int)]
        ates[name] = ate_rmse(kf[:, :3], traj[gt_idx][:, :3])
    return _exchange_row("4_two_robot_exchange", robots, results, ates,
                         n_frames)


def config6_reversed_encounter(n_frames=120, coordinate: bool = True,
                               device: DeviceLike = None) -> Dict:
    """Row 6: two robots on one circle in opposite directions (bestla
    plays its window backwards), so they drive toward each other and the
    overlap forces inter-robot loops from opposing approaches
    (baseline_runs.py:230-289 of the JAX package; the reference's
    kitti_multirobot_reversed_processor.py). bestla's first frame is its
    window's last capture, where its start pose puts it; its keyframes
    are held to the truth through the reversed index."""
    from .multirobot_split import split_frames, split_windows

    world = _world()
    traj = circle_trajectory(n_frames, radius=14.0, laps=1.0)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    overlap = 0.35
    windows = split_windows(n_frames, 2, overlap)
    per_robot = split_frames(frames, 2, overlap, reversed_robots=(1,))
    names = ["atlas", "bestla"]
    cfg = _exchange_cfg()
    init_poses = {"atlas": _init_pose(traj[windows[0][0]]),
                  "bestla": _init_pose(traj[windows[1][1] - 1])}
    robots = {}
    for name in names:
        slam_cfg = dataclasses.replace(cfg.slam, own_name=name,
                                       multi_robot_names=tuple(names),
                                       init_pose=init_poses[name])
        robots[name] = Robot(dataclasses.replace(cfg, slam=slam_cfg),
                             device=device)
    results = replay_multirobot(robots, dict(zip(names, per_robot)),
                                tick_every=8, coordinate=coordinate)
    ates = {}
    for name, (s, e) in zip(names, windows):
        own = sorted(robots[name].slam.db.own_keyframes(),
                     key=lambda k: k.stamp)
        if not own:
            ates[name] = None
            continue
        est = results[name].keyframe_trajectory
        idx = []
        for k in own:
            j = int(round(k.stamp / 0.1)) - s
            idx.append(e - 1 - j if name == "bestla" else s + j)
        ates[name] = ate_rmse(est[:, :3],
                              traj[np.clip(idx, 0, n_frames - 1)][:, :3])
    return _exchange_row("6_reversed_encounter", robots, results, ates,
                         n_frames)


def build_ring_graph(n_nodes=256, capacity_nodes=None, capacity_edges=None,
                     backend="cg", seed=3, noise_scale=0.03,
                     device: DeviceLike = None) -> GraphSLAM:
    """A noisy ring pose graph with one loop edge, on `device` (the card
    unless said otherwise): ground truth on a 20 m circle, odometry
    perturbed by exp of N(0, noise_scale) twists drawn from `seed`,
    estimates accumulated along the chain from a fixed first node, and
    the true last-to-first edge at four times the information. The same
    seed gives the JAX package's graph."""
    rng = np.random.default_rng(seed)
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    gs = GraphSLAM(OptimizerConfig(solver_backend=backend),
                   capacity_nodes=capacity_nodes or max(n_nodes, 64),
                   capacity_edges=capacity_edges or 2 * n_nodes,
                   device=device)
    th = 2 * np.pi * np.arange(n_nodes) / n_nodes
    twists = np.stack([20 * np.cos(th), 20 * np.sin(th), np.zeros(n_nodes),
                       np.zeros(n_nodes), np.zeros(n_nodes), th],
                      axis=1).astype(np.float32)
    gt = se3.pose_exp(torch.from_numpy(twists)).numpy()
    # one (n-1, 6) draw: the generator's sequence of the JAX package's
    noise = se3.pose_exp(torch.from_numpy(rng.normal(
        scale=noise_scale, size=(n_nodes - 1, 6)).astype(np.float32))).numpy()
    est, ids = [gt[0]], [gs.add_se3_node(gt[0], fixed=True)]
    for i in range(1, n_nodes):
        rel = se3np.pose_between(gt[i - 1], gt[i])
        reln = se3np.pose_compose(rel, noise[i - 1])
        est.append(se3np.pose_compose(est[-1], reln))
        ids.append(gs.add_se3_node(est[-1]))
        gs.add_se3_edge(ids[i - 1], ids[i], reln, info)
    gs.add_se3_edge(ids[-1], ids[0],
                    se3np.pose_between(gt[-1], gt[0]), info * 4)
    return gs


def config5_distributed(n_nodes=256, n_ranks=8,
                        device: DeviceLike = None) -> Dict:
    """Row 5: `build_ring_graph(n_nodes)` solved by the cg LM (40
    iterations) on one device and over `n_ranks` ranks, each a process on
    `device` (the card unless said otherwise; ranks that share a card
    join by gloo). Returns the JAX package's keys ("devices" counts the
    ranks), whether every rank returned bitwise the same poses, the solve
    walls and the all-reduces of the distributed solve."""
    from ..graph import solve
    from ..parallel import dist_solver as ds

    dev = resolve_device(device)
    g = build_ring_graph(n_nodes=n_nodes, device="cpu").snapshot()
    cfg = OptimizerConfig(solver_backend="cg", g2o_solver_num_iterations=40)
    t0 = time.perf_counter()
    single = solve.optimize(ds.graph_to(g, dev), cfg)
    sp = single.poses.cpu().numpy()[:n_nodes, :3]  # ends the solve
    single_s = time.perf_counter() - t0
    ranks = ds.run_ranks(ds.solve_graphs, n_ranks, dev, args=([(g, cfg)],))
    dist = ranks[0][0]
    return {"config": "5_distributed_mesh_solve",
            "devices": n_ranks, "nodes": n_nodes,
            "chi2_single": float(single.chi2_final),
            "chi2_distributed": dist["chi2_final"],
            "max_pose_divergence_m": float(np.abs(
                dist["poses"][:n_nodes, :3] - sp).max()),
            "ranks_bitwise_equal": ds.ranks_equal(ranks),
            "backend": ds.group_backend(dev, n_ranks),
            "single_solve_s": single_s, "distributed_solve_s": max(
                r[0]["wall_s"] for r in ranks),
            "lm_iterations": dist["iterations"],
            "cg_iterations": dist["cg_iterations"],
            "all_reduces": dist["all_reduces"],
            "all_reduce_ms": max(r[0]["all_reduce_s"] for r in ranks)
            / max(dist["all_reduces"], 1) * 1e3,
            "peak_allocated_bytes": [r[0]["peak_allocated_bytes"]
                                     for r in ranks]}


def _quat_axis_angle(w: np.ndarray) -> np.ndarray:
    """Rotation vectors (..., 3) -> unit quaternions (..., 4), w first."""
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    axis = w / np.maximum(th, 1e-12)
    return np.concatenate([np.cos(th / 2), np.sin(th / 2) * axis], axis=-1)


def family_graph_spec(n_nodes: int = 256, seed: int = 0) -> Dict:
    """A ring pose graph that carries every prior and plane family, as
    numpy: the workload that holds the solvers' prior and plane paths to
    the JAX package's (`fill_family_graph` fills either package's
    GraphSLAM from it).

    Ground truth on a 20 m circle whose height and tilt wave gently;
    odometry edges perturbed by N(0, 0.03) twists and a last-to-first
    loop, the estimates accumulated from a fixed first node; an XYZ prior
    on every 8th node and an XY prior on every 8th from the 4th (sigma
    0.5 m, z 1 m), a quaternion and a gravity-vector prior on every 4th
    (sigma 0.05); the fixed floor plane z = 0 with an SE3-plane edge to
    every node (sigma 0.05, the local plane of the true pose, perturbed);
    a free wall x = 25 started off by 0.1 rad and 0.4 m with a normal and
    a distance prior; a second free wall x = 30, tied to the first by an
    identity edge (offset (0, 0, 0, -5)) and a parallel edge, and the
    first wall perpendicular to the floor."""
    from ..utils import se3np

    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(n_nodes) / n_nodes
    gt_t = np.stack([20 * np.cos(th), 20 * np.sin(th),
                     0.3 * np.sin(3 * th)], 1)
    gt_w = np.stack([0.05 * np.sin(5 * th), 0.05 * np.cos(4 * th), th], 1)
    gt = np.concatenate([gt_t, _quat_axis_angle(gt_w)], 1).astype(np.float32)
    noise_t = rng.normal(scale=0.03, size=(n_nodes - 1, 3))
    noise_q = _quat_axis_angle(rng.normal(scale=0.03, size=(n_nodes - 1, 3)))
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    est, odom = [gt[0]], []
    for i in range(1, n_nodes):
        rel = se3np.pose_between(gt[i - 1], gt[i])
        reln = se3np.pose_compose(rel, np.concatenate(
            [noise_t[i - 1], noise_q[i - 1]]).astype(np.float32))
        odom.append((i - 1, i, reln, info))
        est.append(se3np.pose_compose(est[-1], reln))
    odom.append((n_nodes - 1, 0, se3np.pose_between(gt[-1], gt[0]),
                 info * 4))

    def noisy(x, s):
        return (np.asarray(x) + rng.normal(scale=s, size=np.shape(x))
                ).astype(np.float32)

    xyz = [(i, noisy(gt[i, :3], 0.5),
            np.diag([4.0, 4.0, 1.0]).astype(np.float32))
           for i in range(0, n_nodes, 8)]
    xy = [(i, noisy(gt[i, :2], 0.5), np.eye(2, dtype=np.float32) * 4.0)
          for i in range(4, n_nodes, 8)]
    quat = []
    vec = []
    for i in range(0, n_nodes, 4):
        q = se3np.quat_mul(gt[i, 3:7], _quat_axis_angle(
            rng.normal(scale=0.05, size=3)))
        quat.append((i, q.astype(np.float32),
                     np.eye(3, dtype=np.float32) * 400.0))
        up = se3np.quat_rotate(se3np.quat_conjugate(gt[i, 3:7]),
                               np.asarray([0.0, 0.0, 1.0]))
        up = noisy(up, 0.05)
        vec.append((i, np.asarray([0.0, 0.0, 1.0], np.float32),
                    up / np.linalg.norm(up),
                    np.eye(3, dtype=np.float32) * 400.0))
    floor = []
    for i in range(n_nodes):
        R = np.stack([se3np.quat_rotate(gt[i, 3:7], e) for e in np.eye(3)], 1)
        n_l = R.T @ np.asarray([0.0, 0.0, 1.0])
        local = np.concatenate([noisy(n_l, 0.02), noisy(gt[i, 2:3], 0.02)])
        floor.append((i, local,
                      np.eye(3, dtype=np.float32) * 400.0))
    n0 = np.asarray([np.cos(0.1), np.sin(0.1), 0.0])
    return dict(
        n_nodes=n_nodes, poses=np.stack(est).astype(np.float32),
        odometry=odom, prior_xyz=xyz, prior_xy=xy, prior_quat=quat,
        prior_vec=vec, floor_edges=floor,
        planes=[(np.asarray([0, 0, 1, 0], np.float32), True),
                (np.asarray([*n0, -24.6], np.float32), False),
                (np.asarray([*n0, -30.3], np.float32), False)],
        plane_prior_normal=[(1, np.asarray([1, 0, 0], np.float32),
                             np.eye(3, dtype=np.float32) * 100.0)],
        plane_prior_distance=[(1, -25.0, 100.0)],
        plane_identity=[(1, 2, np.asarray([0, 0, 0, -5], np.float32),
                         np.eye(4, dtype=np.float32) * 100.0)],
        plane_parallel=[(1, 2, np.zeros(3, np.float32),
                         np.eye(3, dtype=np.float32) * 100.0)],
        plane_perpendicular=[(0, 1, 0.0, 100.0)])


def fill_family_graph(gs, spec: Dict):
    """Fill a GraphSLAM (this package's or the JAX package's: the same
    add_* calls) from `family_graph_spec`; the first node is fixed.
    Returns `gs`."""
    for i, pose in enumerate(spec["poses"]):
        gs.add_se3_node(pose, fixed=(i == 0))
    for a, b, meas, info in spec["odometry"]:
        gs.add_se3_edge(a, b, meas, info)
    for i, xyz, info in spec["prior_xyz"]:
        gs.add_se3_prior_xyz_edge(i, xyz, info)
    for i, xy, info in spec["prior_xy"]:
        gs.add_se3_prior_xy_edge(i, xy, info)
    for i, q, info in spec["prior_quat"]:
        gs.add_se3_prior_quat_edge(i, q, info)
    for i, d, m, info in spec["prior_vec"]:
        gs.add_se3_prior_vec_edge(i, d, m, info)
    for coeffs, fixed in spec["planes"]:
        gs.add_plane_node(coeffs, fixed=fixed)
    for i, local, info in spec["floor_edges"]:
        gs.add_se3_plane_edge(i, 0, local, info)
    for j, normal, info in spec["plane_prior_normal"]:
        gs.add_plane_prior_normal_edge(j, normal, info)
    for j, dist, info in spec["plane_prior_distance"]:
        gs.add_plane_prior_distance_edge(j, dist, info)
    for a, b, meas, info in spec["plane_identity"]:
        gs.add_plane_identity_edge(a, b, meas, info)
    for a, b, meas, info in spec["plane_parallel"]:
        gs.add_plane_parallel_edge(a, b, meas, info)
    for a, b, dot, info in spec["plane_perpendicular"]:
        gs.add_plane_perpendicular_edge(a, b, meas_dot=dot, info1=info)
    return gs


def family_graph_capacities(spec: Dict) -> Dict[str, int]:
    """GraphSLAM capacities that hold `family_graph_spec(n)` exactly
    (the node capacity n, a power of two, as the chain backend wants)."""
    n = spec["n_nodes"]
    return dict(capacity_nodes=n, capacity_edges=len(spec["odometry"]),
                capacity_planes=len(spec["planes"]),
                capacity_priors=sum(len(spec[k]) for k in (
                    "prior_xyz", "prior_xy", "prior_quat", "prior_vec")),
                capacity_plane_edges=len(spec["floor_edges"]),
                capacity_plane_priors=2, capacity_plane_plane=3)


# what a row dict carries besides its numbers: the stores and the
# optimized poses stay in memory
_NOT_SAVED = ("graphs", "keyframe_trajectory")


def _jsonable(x):
    """A row's value as JSON: dicts, lists and numbers; numpy arrays as
    lists, dataclasses (TickStats) as dicts."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()
                if k not in _NOT_SAVED}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _jsonable(dataclasses.asdict(x))
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them
    (`--query-gpu=name,power.limit`)."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(out_path: str = "BASELINE_TORCH.json",
         device: DeviceLike = None) -> Dict:
    """Run the acceptance rows and merge them into `out_path`.

    The JAX package's row set: rows 1, 2, 3, 4, 6 and 7, the fused rows
    1 and 2, and row 5 (one device and eight ranks), on the card unless
    `device` says otherwise (with no card and no `device` this raises
    before a row runs). Card rows land under "results_cuda" with the
    card's name and power limit beside them, CPU rows under "results",
    each row tagged with its device. Other keys of an existing file are
    kept; the "pending" list of rows without a port is gone, as every row
    has one.
    """
    dev = resolve_device(device)
    results = [config1_odometry_only(device=dev),
               config2_full_slam(device=dev),
               config3_floor_augmented(device=dev),
               config4_two_robot(device=dev),
               config6_reversed_encounter(device=dev),
               config7_dynamic_world(device=dev),
               config1_odometry_only(fused=True, device=dev),
               config2_full_slam(fused=True, device=dev),
               config5_distributed(device=dev)]
    results = [dict(_jsonable(r), device=dev.type) for r in results]
    try:
        with open(out_path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        payload = {}
    payload["note"] = ("synthetic-world acceptance runs of the PyTorch "
                       "port (mrg_slam_tpu_torch/pipeline/baseline_runs.py"
                       "); BASELINE_SYNTH.json is the JAX package's")
    payload.pop("pending", None)
    if dev.type == "cuda":
        payload["results_cuda"] = results
        payload["card"] = card_name()
    else:
        payload["results"] = results
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(json.dumps(results, indent=2))
    return payload


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("out", nargs="?", default="BASELINE_TORCH.json")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    a = ap.parse_args()
    main(a.out, device=a.device)
