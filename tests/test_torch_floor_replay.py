"""Acceptance row 3 (`3_floor_augmented`) cut in depth: the port's `replay`
with floor detection and the floor processor against the JAX package's,
on the row's first 30 frames at its width (8192 raw -> 1024 filtered
points, the flat-ground world of seed 21, a tick every 20 frames).

The port's floor detector is fed the JAX package's RANSAC triplets
(test_torch_floor.JaxTriplets replays its key stream), and the JAX
package's nearest neighbours run with exact differences (ROADMAP.md §3
B1); per-tick marginals are off on both sides (tests/test_torch_graph.py
and tests/test_torch_plane_edges.py hold them), and one robot name
(the port's MrgSlam refuses others, item 14).

Gates: the same keyframes and plane edges; ATE within 0.01 m of the JAX
package's (float32 solves in two libraries, whose covariances differ by
rounding noise that moves a solve by up to ~1 cm, ROADMAP.md §3).
"""

import dataclasses

import numpy as np
import pytest

from mrg_slam_tpu.config import OptimizerConfig as JOptimizerConfig
from mrg_slam_tpu.io.synthetic import circle_trajectory
from mrg_slam_tpu.pipeline import baseline_runs as jbl
from mrg_slam_tpu.pipeline import replay as jreplay

from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.pipeline import replay as treplay

from test_torch_floor import JaxTriplets
from test_torch_multirobot import exact_jax_nn, one_thread  # noqa: F401

FRAMES, TICK = 30, 20


def _jcfg():
    """Row 3's configuration (the JAX package's config3_floor_augmented),
    one robot, no per-tick marginals."""
    cfg = jbl._base_cfg()
    slam = dataclasses.replace(
        cfg.slam, multi_robot_names=("atlas",),
        optimizer=JOptimizerConfig(solver_backend="dense",
                                   g2o_solver_num_iterations=64,
                                   per_tick_marginals="none"),
        floor_coeffs=dataclasses.replace(cfg.slam.floor_coeffs,
                                         enable_floor_coeffs=True))
    return dataclasses.replace(
        cfg, slam=slam,
        floor=dataclasses.replace(cfg.floor, enable_floor_detection=True,
                                  sensor_height=1.5, height_clip_range=1.0,
                                  floor_pts_thresh=150))


def test_floor_row_matches_jax(exact_jax_nn):
    world = jbl._world(flat_ground=True)
    traj = circle_trajectory(100, radius=12.0, laps=1.1)[:FRAMES]
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    jcfg = _jcfg()
    jrobot = jreplay.Robot(jcfg)
    want = jreplay.replay(jrobot, frames, tick_every=TICK,
                          gt_xyz=traj[:, :3])
    trobot = treplay.Robot(config_from_fields(dataclasses.asdict(jcfg)),
                           device="cpu", floor_sampler=JaxTriplets(0))
    got = treplay.replay(trobot, frames, tick_every=TICK, gt_xyz=traj[:, :3])
    assert len(got.keyframe_trajectory) == len(want.keyframe_trajectory) > 5
    assert (trobot.slam.db.graph.num_plane_edges
            == jrobot.slam.db.graph.num_plane_edges
            == len(got.keyframe_trajectory))
    assert got.num_loops == want.num_loops
    assert abs(got.ate - want.ate) < 0.01
    np.testing.assert_allclose(trobot.slam.db.graph.planes,
                               jrobot.slam.db.graph.planes)
    # every keyframe's floor coefficients equal the JAX package's
    for a, b in zip(sorted(trobot.slam.db.own_keyframes(),
                           key=lambda k: k.stamp),
                    sorted(jrobot.slam.db.own_keyframes(),
                           key=lambda k: k.stamp)):
        assert a.stamp == pytest.approx(b.stamp)
        np.testing.assert_allclose(a.floor_coeffs, b.floor_coeffs,
                                   atol=1e-4)
