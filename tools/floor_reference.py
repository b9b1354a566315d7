"""Acceptance row 3 and the prior/plane family graph through the JAX package.

Runs the JAX package on the CPU over:

- `3_floor_augmented` (pipeline/baseline_runs.py:154-174 of the JAX
  package) at the row's width: `_base_cfg()` (8192 raw -> 1024 filtered
  points) with floor detection on (sensor height 1.5 m, clip range
  1.0 m, 150 floor points) and `enable_floor_coeffs`, the flat-ground
  world of seed 21, 100 frames of 1.1 laps of a 12 m circle through
  `replay`, a tick every 20 frames. Prints ATE, loops, keyframes, plane
  edges and the floor detections accepted;
- `family_graph_spec(256, seed 0)` (the PyTorch port's
  pipeline/baseline_runs.py, numpy only), filled into the JAX package's
  GraphSLAM and solved by the dense, cg and chain backends with 40 LM
  iterations each. Prints chi2 before and after and LM iterations.

One JSON line; the PyTorch port's `chip_smoke.py` keeps its numbers as
`REF_FLOOR` and `REF_FAMILY`. The floor detector's RANSAC triplets come
from jax.random here and from a torch.Generator in the port, so plane
edges are compared within a band, not exactly.

    python tools/floor_reference.py

Runs on the CPU in a few minutes.
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

from mrg_slam_tpu.config import OptimizerConfig  # noqa: E402
from mrg_slam_tpu.graph.builder import GraphSLAM  # noqa: E402
from mrg_slam_tpu.io.synthetic import circle_trajectory  # noqa: E402
from mrg_slam_tpu.pipeline import baseline_runs as bl  # noqa: E402
from mrg_slam_tpu.pipeline.replay import Robot, replay  # noqa: E402

# the spec is numpy: the same graph goes to both packages
from mrg_slam_tpu_torch.pipeline.baseline_runs import (  # noqa: E402
    family_graph_capacities, family_graph_spec, fill_family_graph)

FAMILY_NODES, FAMILY_SEED, FAMILY_ITERS = 256, 0, 40


def floor_row(n_frames=100):
    """baseline_runs.config3_floor_augmented, keeping the robot."""
    cfg = bl._base_cfg()
    cfg = dataclasses.replace(
        cfg,
        floor=dataclasses.replace(cfg.floor, enable_floor_detection=True,
                                  sensor_height=1.5, height_clip_range=1.0,
                                  floor_pts_thresh=150),
        slam=dataclasses.replace(cfg.slam, floor_coeffs=dataclasses.replace(
            cfg.slam.floor_coeffs, enable_floor_coeffs=True)))
    world = bl._world(flat_ground=True)
    traj = circle_trajectory(n_frames, radius=12.0, laps=1.1)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    robot = Robot(cfg)
    accepted = []
    detect = robot.floor.detect

    def counted(cloud, stamp=0.0):
        out = detect(cloud, stamp)
        accepted.append(out is not None)
        return out

    robot.floor.detect = counted
    t0 = time.perf_counter()
    res = replay(robot, frames, tick_every=20, gt_xyz=traj[:, :3])
    return dict(ate_m=res.ate, rpe_m=res.rpe, loops=res.num_loops,
                keyframes=len(robot.slam.trajectory()),
                plane_edges=robot.slam.db.graph.num_plane_edges,
                detections=sum(accepted), frames=n_frames,
                seconds=time.perf_counter() - t0)


def family_solves():
    spec = family_graph_spec(FAMILY_NODES, FAMILY_SEED)
    out = {}
    for backend in ("dense", "cg", "chain"):
        gs = fill_family_graph(GraphSLAM(
            OptimizerConfig(solver_backend=backend,
                            g2o_solver_num_iterations=FAMILY_ITERS,
                            per_tick_marginals="none"),
            **family_graph_capacities(spec)), spec)
        t0 = time.perf_counter()
        gs.optimize()
        out[backend] = dict(chi2_initial=gs.chi2_initial,
                            chi2=gs.chi2_final,
                            iterations=gs.last_iterations,
                            seconds=time.perf_counter() - t0)
    return out


def main():
    t0 = time.perf_counter()
    out = {"3_floor_augmented": floor_row(),
           "family_graph": dict(nodes=FAMILY_NODES, seed=FAMILY_SEED,
                                iterations=FAMILY_ITERS,
                                **family_solves()),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
