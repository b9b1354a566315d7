"""The port's back-end parts against the JAX package's, on the same numpy
inputs: the pair program, fitness, information matrices, keyframe
admission, covariance prefetch, configs, and what the port refuses. The
whole slice runs in tests/test_torch_slice.py.

Inputs: bench-like scans of a small synthetic world (256-point clouds),
odometry poses made from the ground truth with a seeded drift, and the
clouds' GICP covariances, all as numpy; both packages get the same ones.

Tolerances and why:
- align_pairs_packed: converged, iterations and inliers equal, poses
  within 1e-4, both fitness values within rel 1e-4 (the same float32
  Gauss-Newton; the JAX package's CPU nearest neighbour rounds d2 through
  |s|^2 + |t|^2 - 2 s.t, the port's from exact differences, up to ~1e-4
  m^2 at these coordinates). The gated rows use the back end's gate,
  2.0 m: a 0.3 m gate put one pair within that rounding of the gate, so
  the reference counted it and the port did not (a mean over ~100 pairs
  moved by 7e-4 relative; ROADMAP.md §3, reference finding 1).
- marginals(exact=True) on the ring of tests/test_torch_graph.py (at its
  initial poses): within rel 1e-3 of the largest covariance entry of the
  JAX package's (float32 Cholesky inverses of the same Hessian).
- fitness_score: within rel 1e-5 of a float64 brute force, and within
  rel 1e-3 of the JAX package, whose d2 rounding (above) moves a mean of
  ~0.1 m^2 by ~1e-4 relative.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu import config as jconfig
from mrg_slam_tpu.models.information_matrix import (
    InformationMatrixCalculator as JInfo)
from mrg_slam_tpu.models.keyframe_updater import (
    KeyframeUpdater as JKeyframeUpdater)
from mrg_slam_tpu.models.pair_runner import PairRunner as JPairRunner
from mrg_slam_tpu.graph import solve as jsolve
from mrg_slam_tpu.ops import fitness as jfitness
from mrg_slam_tpu.ops import registration as jreg
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.ops.covariance import GICPCloud as JGICPCloud

from mrg_slam_tpu_torch import config as tconfig
from mrg_slam_tpu_torch.config import PrefilterConfig
from mrg_slam_tpu_torch.convert import config_from_fields, graph_from_numpy
from mrg_slam_tpu_torch.graph import solve
from mrg_slam_tpu_torch.io.synthetic import SyntheticWorld, circle_trajectory
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.models.information_matrix import (
    InformationMatrixCalculator)
from mrg_slam_tpu_torch.models.keyframe import KeyFrame
from mrg_slam_tpu_torch.models.keyframe_updater import KeyframeUpdater
from mrg_slam_tpu_torch.models.pair_runner import PairRunner
from mrg_slam_tpu_torch.ops import knn
from mrg_slam_tpu_torch.ops import registration as reg
from mrg_slam_tpu_torch.ops.cloud import PAD_VALUE, PointCloud
from mrg_slam_tpu_torch.ops.covariance import GICPCloud
from mrg_slam_tpu_torch.ops.fitness import fitness_score
from mrg_slam_tpu_torch.ops.prefilter import prefilter
from mrg_slam_tpu_torch.utils import se3np

from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)

CAP, FRAMES = 256, 66
JREG = jconfig.RegistrationConfig(
    registration_method="SMALL_GICP", reg_transformation_epsilon=1e-3,
    reg_maximum_iterations=16, reg_max_correspondence_distance=2.0,
    reg_covariance_mode="radius", reg_covariance_radius=1.0,
    reg_stall_epsilon=0.01, reg_coarse_stride=2, reg_coarse_iterations=6)
JSLAM = jconfig.SlamConfig(
    own_name="atlas", multi_robot_names=("atlas",), keyframe_delta_trans=2.0,
    capacity_keyframes=64, capacity_edges=128, capacity_keyframe_points=CAP,
    registration=JREG,
    optimizer=jconfig.OptimizerConfig(solver_backend="dense",
                                      g2o_solver_num_iterations=64),
    loop=dataclasses.replace(jconfig.LoopClosureConfig(),
                             capacity_candidates=4,
                             fitness_score_max_range=2.0),
    robot_remove_points_radius=0.0)
SLAM = config_from_fields(dataclasses.asdict(JSLAM))
REG = SLAM.registration


@pytest.fixture(scope="module")
def world():
    return make_world()


def make_world():
    """1.2 laps of a 12 m circle: clouds, covariances, odometry, truth."""
    w = SyntheticWorld.build(seed=5, extent=30.0, n_ground=25000,
                             n_pillars=25, n_walls=10,
                             max_points_per_scan=4096, noise=0.02)
    traj = circle_trajectory(FRAMES, radius=12.0, laps=1.2)
    pre = PrefilterConfig(downsample_resolution=0.5,
                          capacity_filtered_points=CAP,
                          outlier_removal_method="NONE")
    rng = np.random.default_rng(3)
    start_inv = se3np.pose_inverse(traj[0])
    drift = se3np.pose_identity()
    clouds, covs, odom = [], [], []
    for i, p in enumerate(traj):
        step = np.concatenate([rng.normal(0, 0.01, 3), [1.0],
                               rng.normal(0, 0.002, 3)]).astype(np.float32)
        step[3:] /= np.linalg.norm(step[3:])
        if i:
            drift = se3np.pose_compose(drift, step)
        odom.append(se3np.pose_compose(se3np.pose_compose(start_inv, p),
                                       drift))
        c = prefilter(PointCloud.from_array(w.scan(p, seed=i), 4096,
                                            device="cpu"), pre)
        clouds.append((c.points.numpy(), c.mask.numpy()))
        covs.append(reg.make_source(c, REG).covs.numpy())
    return dict(traj=traj, clouds=clouds, covs=covs, odom=odom)


def _rows(world):
    """8 pair rows of the world's clouds: evaluate-only rows (one with a
    gated fitness), registrations from perturbed guesses with a ragged
    source, a disjoint row (no correspondence: the stall exit's dead
    end), a row far off its pair (it stalls), and budgets of 1 and 3 (no
    coarse iteration, and a 2 + 1 split)."""
    rng = np.random.default_rng(7)
    clouds, odom = world["clouds"], world["odom"]

    def cloud(i, keep=CAP, shift=0.0):
        p, m = clouds[i][0].copy(), clouds[i][1].copy()
        m[keep:] = False
        p[~m] = PAD_VALUE
        p[m] += np.float32(shift)
        return p, m, world["covs"][i]

    def guess(i, j, noise):
        rel = se3np.pose_between(odom[i], odom[j])
        xi = rng.normal(scale=noise, size=6) * [1, 1, 0.3, 0.02, 0.02, 0.05]
        q = np.concatenate([[1.0], 0.5 * xi[3:]])
        return se3np.pose_compose(rel, np.concatenate(
            [xi[:3], q / np.linalg.norm(q)]).astype(np.float32))

    return [  # (target, source, init, max_iters, fitness range)
        (cloud(10), cloud(12), guess(10, 12, 0), 0, math.inf),
        (cloud(10), cloud(12), guess(10, 12, 0), 0, 2.0),
        (cloud(20), cloud(22, keep=200), guess(20, 22, 1.0), 16, 2.0),
        (cloud(30), cloud(31), guess(30, 31, 1.0), 16, 2.0),
        (cloud(0), cloud(40, shift=100.0), guess(0, 40, 0), 16, 2.0),
        (cloud(5), cloud(17), se3np.pose_identity(), 16, 2.0),
        (cloud(50), cloud(52), guess(50, 52, 1.0), 1, 2.0),
        (cloud(44), cloud(46), guess(44, 46, 1.0), 3, 2.0)]


def _run_jax(rows):
    def g(c):
        return JGICPCloud(*(jnp.asarray(x) for x in c))

    return np.asarray(jreg.align_pairs_packed(
        JREG, [g(r[0]) for r in rows], [g(r[1]) for r in rows],
        jnp.asarray(np.stack([r[2] for r in rows])),
        jnp.asarray([r[3] for r in rows], jnp.int32),
        jnp.asarray([r[4] for r in rows], jnp.float32)))


def _run_port(rows):
    def g(c):
        return GICPCloud(*(torch.from_numpy(np.array(x)) for x in c))

    return reg.align_pairs_packed(
        REG, [g(r[0]) for r in rows], [g(r[1]) for r in rows],
        np.stack([r[2] for r in rows]), [r[3] for r in rows],
        [r[4] for r in rows])


def _check_rows(got, want):
    np.testing.assert_array_equal(got[:, 7:10], want[:, 7:10])
    np.testing.assert_allclose(got[:, :7], want[:, :7], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, 10:], want[:, 10:], rtol=1e-4)


@pytest.fixture(scope="module")
def pair_rows(world):
    rows = _rows(world)
    return rows, _run_jax(rows), _run_port(rows)


def test_align_pairs_packed_matches_jax(pair_rows):
    rows, want, got = pair_rows
    got = got.numpy()
    assert got.shape == (8, 12) and got.dtype == np.float32
    _check_rows(got, want)
    it, conv = got[:, 8], got[:, 7]
    # evaluate-only rows keep their guess and run no iteration
    assert (it[:2] == 0).all() and (conv[:2] == 0).all()
    np.testing.assert_array_equal(got[:2, :7], np.stack([rows[0][2],
                                                         rows[1][2]]))
    assert got[1, 11] < got[1, 10]  # the gate drops the far pairs
    assert conv[2] == 1 and conv[3] == 1
    # the disjoint row: no correspondence, so one iteration in each
    # stage, unconverged
    assert it[4] == 2 and conv[4] == 0 and got[4, 9] == 0
    assert math.isinf(got[4, 11]) and got[4, 10] > 1e3
    assert it[6] == 1 and it[7] <= 3


def test_empty_row_matches_jax(world):
    """A row without a valid lane: no correspondence, an infinite
    fitness, the guess kept; it runs in both packages like any row."""
    rows = _rows(world)
    empty = (np.full((CAP, 3), PAD_VALUE, np.float32), np.zeros(CAP, bool),
             np.tile(np.eye(3, dtype=np.float32), (CAP, 1, 1)))
    rows = rows[:7] + [(empty, empty, se3np.pose_identity(), 16, 2.0)]
    want, got = _run_jax(rows), _run_port(rows).numpy()
    _check_rows(got, want)
    assert got[7, 9] == 0 and math.isinf(got[7, 10])


def test_frozen_rows_are_masked_and_change_nothing(pair_rows, monkeypatch):
    """A finished row's source lanes are masked out of every later nn
    sweep, and the (B, 12) rows are bit for bit those of a run that
    sweeps every row to the end."""
    rows, _, got = pair_rows
    live = []
    nn = knn.nearest_neighbor

    def spy(src, tgt, tgt_mask, src_mask=None):
        if src_mask is not None and src_mask.ndim == 2:
            live.append(src_mask.sum(-1))
        return nn(src, tgt, tgt_mask, src_mask)

    monkeypatch.setattr(knn, "nearest_neighbor", spy)
    assert torch.equal(_run_port(rows), got)
    sweeps = torch.stack(live[:-1])  # the last call is the fitness pass
    # a row takes part in exactly the sweeps it iterates in; the others
    # reach the kernel with every source lane masked
    iters = got[:, 8].to(torch.int64)
    assert torch.equal((sweeps > 0).sum(0), iters)
    assert len(sweeps) > iters.min() and (sweeps == 0).any()

    live.clear()
    monkeypatch.setattr(reg, "_live_lanes", lambda mask, active: mask)
    assert torch.equal(_run_port(rows), got)
    assert len(live) == len(sweeps) + 1 and (torch.stack(live) > 0).all()


@pytest.mark.parametrize("max_range", [math.inf, 0.5])
def test_fitness_score_matches_jax(world, max_range):
    (p1, m1), (p2, m2) = world["clouds"][20], world["clouds"][22]
    m2 = m2.copy()
    m2[200:] = False
    rel = se3np.pose_between(world["odom"][20], world["odom"][22])
    want = float(jfitness.fitness_score(
        JCloud(jnp.asarray(p1), jnp.asarray(m1)),
        JCloud(jnp.asarray(p2), jnp.asarray(m2)), jnp.asarray(rel),
        max_range))
    got = fitness_score(PointCloud(torch.from_numpy(p1), torch.from_numpy(m1)),
                        PointCloud(torch.from_numpy(p2), torch.from_numpy(m2)),
                        torch.from_numpy(rel), max_range)
    assert got.shape == () and math.isfinite(want)
    # float64 brute force
    moved = se3np.pose_apply(rel, p2[m2]).astype(np.float64)
    d2 = ((moved[:, None, :] - p1[m1][None].astype(np.float64)) ** 2).sum(-1)
    d2 = d2.min(1)
    golden = d2[d2 <= max_range ** 2].mean()
    np.testing.assert_allclose(float(got), golden, rtol=1e-5)
    np.testing.assert_allclose(float(got), want, rtol=1e-3)
    far = PointCloud(torch.from_numpy(p2 + 500), torch.from_numpy(m2))
    assert math.isinf(float(fitness_score(
        PointCloud(torch.from_numpy(p1), torch.from_numpy(m1)), far,
        torch.from_numpy(rel), 2.0)))


@pytest.mark.parametrize("const", [False, True])
def test_information_matrix_from_fitness_exact(const):
    jcfg = jconfig.InformationMatrixConfig(use_const_inf_matrix=const)
    j, t = JInfo(jcfg), InformationMatrixCalculator(
        config_from_fields(dataclasses.asdict(jcfg)))
    for fit in (0.0, 0.01, 0.3, 1.25, 7.0, math.inf):
        f = t.clamp_fitness(fit)
        assert f == j.clamp_fitness(fit)
        np.testing.assert_array_equal(t.from_fitness(f), j.from_fitness(f))


def test_keyframe_updater_decisions_match_jax():
    rng = np.random.default_rng(4)
    j, t = JKeyframeUpdater(1.0, 0.3), KeyframeUpdater(1.0, 0.3)
    pose = se3np.pose_identity()
    for _ in range(200):
        step = np.concatenate([rng.normal(0, 0.4, 3), [1.0],
                               rng.normal(0, 0.08, 3)]).astype(np.float32)
        step[3:] /= np.linalg.norm(step[3:])
        pose = se3np.pose_compose(pose, step)
        assert t.update(pose) == j.update(pose)
        assert t.accum_distance == j.accum_distance


def test_prefetch_batch_equals_make_source(world):
    kfs = [KeyFrame(robot_name="atlas", stamp=0.1 * i, odom=world["odom"][i],
                    accum_distance=0.0,
                    cloud=PointCloud(torch.from_numpy(world["clouds"][i][0]),
                                     torch.from_numpy(world["clouds"][i][1])))
           for i in range(0, 40, 2)]
    runner = PairRunner(REG)
    runner.prefetch_batch(kfs)  # 20 keyframes: a bucket of 16 and one of 4
    for k in (kfs[0], kfs[17]):
        want = reg.make_source(k.cloud, REG)
        torch.testing.assert_close(k.gicp.covs, want.covs, rtol=0,
                                   atol=1e-5)
    # the JAX package's bucket caps and speculation budget, kept
    jrunner = JPairRunner(JREG)
    for cap in (256, 4096, 8192, 32768):
        assert runner.max_bucket(cap) == jrunner.max_bucket(cap)
        assert (runner.speculation_budget_rows(cap)
                == jrunner.speculation_budget_rows(cap))
    assert runner.max_bucket(8192) == 64


def test_slam_configs_round_trip():
    for name in ("SlamConfig", "LoopClosureConfig", "OptimizerConfig",
                 "InformationMatrixConfig", "GpsConfig", "ImuConfig",
                 "FloorCoeffsConfig", "GraphExchangeConfig"):
        jc = getattr(jconfig, name)()
        tc = config_from_fields(dataclasses.asdict(jc))
        assert type(tc) is getattr(tconfig, name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert SLAM.registration == config_from_fields(
        dataclasses.asdict(JREG))


@pytest.mark.parametrize("change,item", [
    (dict(gps=jconfig.GpsConfig(enable_gps=True)), "gps"),
    (dict(imu=jconfig.ImuConfig(enable_imu_orientation=True,
                                enable_imu_acceleration=True)), "imu"),
    (dict(floor_coeffs=jconfig.FloorCoeffsConfig(enable_floor_coeffs=True)),
     "floor"),
    (dict(enable_fill_first_cloud=True), "fill"),
    (dict(multi_robot_names=("atlas", "bestla")), "others")])
def test_unported_features_raise(world, change, item):
    """The sensor processors, first-cloud filling and other robots in
    multi_robot_names (the exchange, once refused here) are ported:
    MrgSlam takes them, and a tick over six frames (three keyframes) adds
    the processors' edges, or the filled first cloud; with another robot
    named and none on the wire, the tick is the one-robot tick."""
    cfg = config_from_fields(dataclasses.asdict(
        dataclasses.replace(JSLAM, **change)))
    from mrg_slam_tpu_torch.models.floor_detection import FloorCoeffs
    from mrg_slam_tpu_torch.models.processors import GpsFix, ImuSample
    slam = MrgSlam(cfg, device="cpu")
    for i in range(6):
        pts, mask = world["clouds"][i]
        slam.process_scan(i * 0.1, world["odom"][i], PointCloud(
            torch.from_numpy(pts), torch.from_numpy(mask)))
        slam.gps_processor.add_fix(GpsFix(i * 0.1, 48.0 + 1e-5 * i, 11.0,
                                          500.0))
        slam.imu_processor.add_sample(ImuSample(
            i * 0.1, np.asarray([1.0, 0, 0, 0], np.float32),
            np.asarray([0, 0, 9.81], np.float32)))
        slam.floor_processor.add_coeffs(FloorCoeffs(
            i * 0.1, np.asarray([0, 0, 1, 1.5], np.float32)))
    stats = slam.optimization_tick()
    g = slam.db.graph
    assert stats is not None and np.isfinite(stats.chi2_after)
    kfs = len(slam.db.own_keyframes())
    assert kfs == 3
    want = dict(gps=(kfs, 0, 0), imu=(2 * kfs, 0, 0), floor=(0, kfs, 1),
                fill=(0, 0, 0), others=(0, 0, 0))[item]
    assert (g._priors.n, g.num_plane_edges, len(g.planes)) == want
    first = slam.db.own_keyframes()[0]
    assert (first.cloud.capacity > CAP) == (item == "fill")


def test_unported_queues_raise_only_when_used():
    """The static-keyframe and loaded-graph queues raise once used (item
    16); the other robots' graph queue (the exchange, once refused here)
    merges: a delta graph without keyframes records the sender's latest
    keyframe."""
    from mrg_slam_tpu_torch.parallel.messages import GraphMsg
    slam = MrgSlam(SLAM, device="cpu")
    assert slam.optimization_tick() is None  # nothing queued, nothing done
    for queue, item in (("static_keyframe_queue", "item 16"),
                        ("loaded_graph_queue", "item 16")):
        getattr(slam.db, queue).append(object())
        with pytest.raises(NotImplementedError, match=item):
            slam.optimization_tick()
        getattr(slam.db, queue).clear()
    slam.db.add_graph_msg(GraphMsg("bestla", "u", se3np.pose_identity(),
                                   [], []))
    assert slam.optimization_tick() is not None
    assert not slam.db.graph_queue
    assert slam.db.others_last_kf["bestla"][0] == "u"


@pytest.mark.parametrize("reciprocal", [False, True],
                         ids=["nearest", "reciprocal"])
def test_pair_rows_match_single_row_solves(pair_rows, reciprocal):
    """Each row of the batched program solves as the front end's
    single-row `_align_impl` does on its pair (which
    tests/test_torch_ops.py holds to the JAX package), with reciprocal
    correspondences too."""
    rows = pair_rows[0]
    params = dataclasses.replace(
        REG, reg_use_reciprocal_correspondences=reciprocal)
    packed = reg.align_pairs_packed(
        params, *([GICPCloud(*(torch.from_numpy(np.array(x)) for x in r[k]))
                   for r in rows] for k in (0, 1)),
        np.stack([r[2] for r in rows]), [r[3] for r in rows],
        [r[4] for r in rows]).numpy()
    for i, (tgt, src, init, mi, _) in enumerate(rows):
        one = reg._align_impl(
            params, GICPCloud(*(torch.from_numpy(np.array(x)) for x in src)),
            reg.RegistrationTarget(gicp=GICPCloud(
                *(torch.from_numpy(np.array(x)) for x in tgt))),
            torch.from_numpy(init), mi)
        assert int(one.iterations) == packed[i, 8], i
        assert bool(one.converged) == bool(packed[i, 7]), i
        assert int(one.num_inliers) == packed[i, 9], i
        np.testing.assert_allclose(packed[i, :7], one.pose.numpy(), rtol=0,
                                   atol=1e-5)


def test_marginals_exact_match_jax():
    from test_torch_graph import _ring

    g = _ring().snapshot()
    want = np.asarray(jsolve.marginals(g))
    got = solve.marginals(graph_from_numpy(jax.tree.map(np.asarray, g),
                                           device="cpu"), exact=True).numpy()
    assert got.shape == want.shape == (32, 6, 6)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
    assert (got[0] == 0).all() and (got[30:] == 0).all()
