"""The port's single-robot back end as a whole against the JAX package's:
both `MrgSlam`s get the same odometry poses, clouds and covariances of a
small world (1.2 laps, 256-point clouds, tests/test_torch_backend.py's
`make_world`) and tick every 33 frames (two ticks, the second with the
loops).

Tolerances and why: the same keyframes, the same loop pairs (by keyframe
stamps), chi2 per tick within rel 1e-3 and the trajectory within 1e-2 m.
Before the first loop the graph is consistent and its chi2 is float32
rounding noise (~1e-10), so chi2 is compared with an absolute floor of
1e-6, far below the chi2 of any tick with a loop (~0.1).

The JAX package pads each pair bucket to a power of two rows, at least
`PairRunner.MIN_BUCKET`, and compiles its pair program once per bucket
size; padded rows are evaluate-only rows of an empty cloud whose results
it drops. Here its runner pads every bucket to 128 rows, so that one
program serves every tick and the file stays within its time on the CPU;
its bucket cap and speculation budget at this capacity do not move
(asserted below).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.models.backend import MrgSlam as JMrgSlam
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud

from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.ops.cloud import PointCloud

from test_torch_backend import CAP, FRAMES, JSLAM, make_world
from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)

TICK_EVERY = 33
# per-tick marginals off on both sides: tests/test_torch_graph.py holds
# the port's marginals to the JAX package's, and compiling the JAX
# package's would cost this file ~5 s of its time on the CPU
JSLAM_NO_MARGINALS = dataclasses.replace(JSLAM, optimizer=dataclasses.replace(
    JSLAM.optimizer, per_tick_marginals="none"))


def _drive(slam, world, cloud, covs):
    chi2 = []
    for i in range(FRAMES):
        slam.process_scan(i * 0.1, world["odom"][i],
                          cloud(*world["clouds"][i]),
                          source_covs=covs(world["covs"][i]))
        if (i + 1) % TICK_EVERY == 0:
            st = slam.optimization_tick(now=i * 0.1)
            chi2.append((st.chi2_before, st.chi2_after))
    return np.asarray(chi2)


def _loop_stamps(slam):
    kfs = slam.db.uuid_keyframe_map
    return sorted((round(kfs[e.from_uuid].stamp, 3),
                   round(kfs[e.to_uuid].stamp, 3))
                  for e in slam.db.edges if e.type == "loop")


@pytest.fixture(scope="module")
def slices():
    world = make_world()
    jslam = JMrgSlam(JSLAM_NO_MARGINALS)
    runner = jslam.loop_detector.runner
    caps = (runner.max_bucket(CAP), runner.speculation_budget_rows(CAP))
    runner.MIN_BUCKET = 128
    assert caps == (runner.max_bucket(CAP),
                    runner.speculation_budget_rows(CAP))
    jchi2 = _drive(jslam, world,
                   lambda p, m: JCloud(jnp.asarray(p), jnp.asarray(m)),
                   jnp.asarray)
    tslam = MrgSlam(config_from_fields(dataclasses.asdict(
        JSLAM_NO_MARGINALS)), device="cpu")
    tchi2 = _drive(tslam, world,
                   lambda p, m: PointCloud(torch.from_numpy(p),
                                           torch.from_numpy(m)),
                   torch.from_numpy)
    return jslam, jchi2, tslam, tchi2


def test_slice_matches_jax(slices):
    jslam, jchi2, tslam, tchi2 = slices
    n_kf = len(tslam.db.keyframes) + len(tslam.db.new_keyframes)
    assert n_kf == len(jslam.db.keyframes) + len(jslam.db.new_keyframes)
    assert n_kf >= 30
    loops = _loop_stamps(tslam)
    assert loops and loops == _loop_stamps(jslam)
    np.testing.assert_allclose(tchi2, jchi2, rtol=1e-3, atol=1e-6)
    assert tchi2[-1, 0] > 1e-2  # the loops' tick has a chi2 of substance
    jt, tt = jslam.trajectory(), tslam.trajectory()
    assert tt.shape == jt.shape == (n_kf, 7)
    assert np.abs(tt[:, :3] - jt[:, :3]).max() < 1e-2
    stats = tslam.tick_stats
    assert [s.iterations for s in stats] and all(s.pair_buckets
                                                 for s in stats)
    assert sum(s.num_loops for s in stats) == len(loops)
    # odom->map re-estimated from the latest keyframe
    prev = tslam.db.prev_robot_keyframe
    np.testing.assert_allclose(tslam.map_pose(prev.odom),
                               prev.estimate(tslam.db.graph), atol=1e-5)


