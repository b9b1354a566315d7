"""The port's `replay_multirobot` (two robots with the graph exchange,
through `SharedTick`) against the JAX package's, on row 6's layout at a
small size: one lap and a tenth of an 8 m circle in 40 frames
(tests/test_torch_replay.py's world and config at 4096 raw -> 256
filtered points and 3 m keyframes), split into two windows that overlap
by 35 %, the second played backwards, so the robots meet head on; a tick
every 8 rounds, then each robot's slam-pose broadcast to the other.

The JAX package ticks its robots one by one (`coordinate=False`): its
batched LM compiles for ~20 s on the CPU, which this file does not have,
and a coordinated tick is the same tick (tests/test_torch_shared_tick.py
holds the port's to its serial ticks). Its nearest neighbours run with
exact differences, as the port's do (ROADMAP.md §3 B1), its pair buckets
are padded to 128 rows, as tests/test_torch_slice.py pads them (one
program to compile; padded rows are dropped), and the port's
covariances are the JAX package's of the same cloud, as in
tests/test_torch_replay.py, so the two front ends agree to float32
rounding.

Gates: per robot the same keyframes, loops and inter-robot loops and the
same remote keyframes merged; keyframe ATE within 0.02 m of the JAX
package's.
"""

import dataclasses

import jax
import numpy as np
import pytest

from mrg_slam_tpu.ops import knn as jknn
from mrg_slam_tpu.pipeline import multirobot_split as jsplit
from mrg_slam_tpu.pipeline import replay as jreplay

from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.ops import registration as treg
from mrg_slam_tpu_torch.pipeline import multirobot_split as tsplit
from mrg_slam_tpu_torch.pipeline import replay as treplay
from mrg_slam_tpu_torch.utils.metrics import ate_rmse

from test_torch_multirobot import exact_sqdist, one_thread  # noqa: F401
from test_torch_replay import JCFG as JCFG512
from test_torch_replay import _jax_covariances

FRAMES, TICK, OVERLAP = 40, 8, 0.35
NAMES = ("atlas", "bestla")
# tests/test_torch_replay.py's config at 256 filtered points with a
# keyframe every 3 m: the head-on encounter's pair program runs many
# rows, and the CPU's plain nn over them would take this file past its
# time at 512 points and 2 m keyframes
JCFG = dataclasses.replace(
    JCFG512,
    prefilter=dataclasses.replace(JCFG512.prefilter,
                                  capacity_filtered_points=256),
    odometry=dataclasses.replace(JCFG512.odometry,
                                 keyframe_delta_translation=3.0),
    slam=dataclasses.replace(JCFG512.slam, keyframe_delta_trans=3.0,
                             capacity_keyframe_points=256))
CFG = config_from_fields(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def layout():
    from mrg_slam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 circle_trajectory)

    world = SyntheticWorld.build(seed=13, extent=25.0, n_ground=15000,
                                 max_points_per_scan=4096, noise=0.02)
    traj = circle_trajectory(FRAMES, radius=8.0, laps=1.1)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    windows = tsplit.split_windows(FRAMES, 2, OVERLAP)

    def ip(p):
        yaw = 2.0 * np.arctan2(p[6], p[3])
        return (float(p[0]), float(p[1]), float(p[2]), float(yaw), 0.0, 0.0)

    inits = {"atlas": ip(traj[windows[0][0]]),
             "bestla": ip(traj[windows[1][1] - 1])}
    return traj, frames, windows, inits


def _cfgs(base, inits):
    return {n: dataclasses.replace(base, slam=dataclasses.replace(
        base.slam, own_name=n, multi_robot_names=NAMES, init_pose=inits[n]))
        for n in NAMES}


def _metrics(robots, traj, windows):
    """Per robot: keyframes, loops, inter-robot loops, remote keyframes,
    keyframe ATE (bestla's through its reversed window)."""
    out = {}
    for n, (s, e) in zip(NAMES, windows):
        db = robots[n].slam.db
        own = sorted(db.own_keyframes(), key=lambda k: k.stamp)
        idx = [int(round(k.stamp / 0.1)) - s for k in own]
        idx = [e - 1 - j if n == "bestla" else s + j for j in idx]
        est = robots[n].slam.trajectory()
        robot_of = {u: k.robot_name for u, k in db.uuid_keyframe_map.items()}
        loops = [e_ for e_ in db.edges if e_.type == "loop"]
        out[n] = dict(
            keyframes=len(own), loops=len(loops),
            inter=sum(robot_of[x.from_uuid] != robot_of[x.to_uuid]
                      for x in loops),
            remote=sum(k.robot_name != n and k.odom_counter >= 0
                       for k in db.keyframes + db.new_keyframes),
            ate=ate_rmse(est[:, :3], traj[idx][:, :3]))
    return out


def test_replay_multirobot_matches_jax(layout, monkeypatch):
    traj, frames, windows, inits = layout
    split = jsplit.split_frames(frames, 2, OVERLAP, reversed_robots=(1,))
    assert [[f[0] for f in w] for w in split] == [
        [f[0] for f in w] for w in tsplit.split_frames(
            frames, 2, OVERLAP, reversed_robots=(1,))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn, "_chunk_sqdist", exact_sqdist)
        jax.clear_caches()
        jrobots = {n: jreplay.Robot(c)
                   for n, c in _cfgs(JCFG, inits).items()}
        for r in jrobots.values():  # one pair program for every tick
            r.slam.loop_detector.runner.MIN_BUCKET = 128
        jres = jreplay.replay_multirobot(jrobots, dict(zip(NAMES, split)),
                                         tick_every=TICK, coordinate=False)
    jax.clear_caches()
    monkeypatch.setattr(treg, "_covariances", _jax_covariances)
    robots = {n: treplay.Robot(c, device="cpu")
              for n, c in _cfgs(CFG, inits).items()}
    res = treplay.replay_multirobot(robots, dict(zip(NAMES, split)),
                                    tick_every=TICK)
    want, got = _metrics(jrobots, traj, windows), _metrics(robots, traj,
                                                           windows)
    for n in NAMES:
        assert res[n].trajectory.shape == jres[n].trajectory.shape
        assert res[n].num_loops == jres[n].num_loops
        w, g = dict(want[n]), dict(got[n])
        assert abs(g.pop("ate") - w.pop("ate")) < 0.02, n
        assert g == w, n
        assert g["keyframes"] >= 5 and g["remote"] >= 1
    assert sum(got[n]["inter"] for n in NAMES) >= 1
