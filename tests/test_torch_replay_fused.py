"""The port's two replay paths against each other, and the paths
`replay_fused` and `Robot` take instead, on the small world of
tests/test_torch_replay.py (30 frames, a tick every 12, the last block a
ragged 6 that `replay_fused` pads).

Tolerances and why: `replay_fused` against `replay` is held to the JAX
package's own bar (tests/test_rosbag_and_launch.py:86): the same
keyframes, poses within 0.05 m, ATE within 0.05 m. Both run the same
registration; the fused path only batches the covariances of a block, so
on the CPU they agree to ~1e-5 m.
"""

import dataclasses

import numpy as np

from mrg_slam_tpu_torch import config as tconfig
from mrg_slam_tpu_torch.pipeline import replay as treplay

from test_torch_replay import CFG, TICK, frames  # noqa: F401 (a fixture)
from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)


def test_replay_fused_matches_per_frame(frames):
    traj, fr = frames
    r1 = treplay.Robot(CFG, device="cpu")
    res1 = treplay.replay(r1, fr, tick_every=TICK, gt_xyz=traj[:, :3])
    r2 = treplay.Robot(CFG, device="cpu")
    res2 = treplay.replay_fused(r2, fr, tick_every=TICK, gt_xyz=traj[:, :3])
    assert res2.trajectory.shape == res1.trajectory.shape
    np.testing.assert_allclose(res2.stamps, res1.stamps)
    assert len(res2.keyframe_trajectory) == len(res1.keyframe_trajectory)
    assert res2.num_loops == res1.num_loops >= 1
    np.testing.assert_allclose(res2.trajectory[:, :3], res1.trajectory[:, :3],
                               atol=0.05)
    assert abs(res2.ate - res1.ate) < 0.05
    # one tick a block, the ragged tail's included
    assert len(r2.slam.tick_stats) == len(r1.slam.tick_stats)


def test_robot_refuses_floor_and_replay_fused_switches(frames, monkeypatch):
    """`Robot` with floor detection builds (item 12, once refused here).
    With floor detection, deskewing (fed by `add_imu`) or an
    initial-guess front end, `replay_fused` runs the per-frame `replay`,
    as the reference does (replay.py:144-152)."""
    traj, fr = frames
    called = []
    orig = treplay.replay
    monkeypatch.setattr(treplay, "replay",
                        lambda *a, **k: called.append(1) or orig(*a, **k))
    deskew = dataclasses.replace(CFG, prefilter=dataclasses.replace(
        CFG.prefilter, enable_deskewing=True))
    robot = treplay.Robot(deskew, device="cpu")
    robot.add_imu(0.0, [0.0, 0.0, 0.05], [0.0, 0.0, 9.81], [1.0, 0, 0, 0])
    res = treplay.replay_fused(robot, fr[:4], tick_every=TICK,
                               gt_xyz=traj[:4, :3])
    assert called and res.trajectory.shape == (4, 7)
    assert np.isfinite(res.trajectory).all()
    guess = dataclasses.replace(CFG, odometry=dataclasses.replace(
        CFG.odometry, enable_robot_odometry_init_guess=True))
    treplay.replay_fused(treplay.Robot(guess, device="cpu"), fr[:2])
    assert len(called) == 2
    floor = treplay.Robot(dataclasses.replace(
        CFG, floor=tconfig.FloorDetectionConfig(
            enable_floor_detection=True, sensor_height=1.5,
            floor_pts_thresh=20)), device="cpu")
    assert floor.floor is not None
    res = treplay.replay_fused(floor, fr[:2], tick_every=TICK)
    assert len(called) == 3 and res.trajectory.shape == (2, 7)
    # the detector's coefficients wait in the floor processor's queue or
    # became plane edges
    assert floor.slam.floor_processor.queue or \
        floor.slam.db.graph.num_plane_edges
