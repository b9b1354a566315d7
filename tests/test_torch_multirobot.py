"""The parts of the port's co-hosting of R robots on one card against the
JAX package's: the odometry of R robots (`run_batch_multi`, also against
the port's own single-robot `run_batch`), the multi-chain
`GraphDatabase`, other-robot point removal and map assembly with its PCD
files. `SharedGraphSlam` as a whole is in tests/test_torch_shared.py.

Inputs: two robots on a small world, 256-lane clouds prefiltered by the
JAX package (both packages get the same points and masks). Robot 0 moves
~1 m a frame (a keyframe switch every second frame or so at the 2 m
gate), robot 1 ~0.3 m (no switch after its first frame), so one row
switches keyframes while the other does not.

Tolerances and why:
- Against the JAX package, with the JAX package's covariances fed to the
  port (as tests/test_torch_odometry.py does for `run_batch`): identical
  keyframe flags and inlier counts, poses within 1e-4 m and 1e-4 on
  quaternion components (float32 Gauss-Newton in two libraries). The JAX
  package's nearest neighbour runs with exact coordinate differences, as
  its Pallas kernel computes it on a TPU: its CPU path rounds d2 through
  |s|^2 + |t|^2 - 2 s.t (ROADMAP.md §3, reference finding 1), and on
  these clouds that moved one pair across the 2 m correspondence gate
  and a 256-point solve by 3.4 cm. The robot-stacked carry crosses from
  the JAX package through `convert.carry_from_numpy`.
- Row r against `run_batch` on robot r alone: identical keyframe flags
  and iterations, poses within 1e-5. Not bit for bit: the R-row solve
  forms each row's 6x6 Hessian and gradient with batched products
  ((R, N, 3, 6) einsums and (R, N, 3, 3) matmuls) whose float32 sums run
  in another order than the single row's (N, 3, 6) einsum, so the two
  round differently in the last bits.
- The ragged-tail fallback (bench.py:413-430, per-robot `run_batch` when
  a robot's window does not fill the block) driven through bench's
  ingest loop with `SharedGraphSlam`: each robot's odometry within 1e-4
  of one `run_batch` over its whole window (block boundaries only change
  how the covariance pass batches and the rows' summation order).
- The multi-chain store: counters, chains, anchors and node estimates as
  the JAX package's tests/test_shared_graph.py checks them, estimates
  within 1e-5 of the JAX package's (float32 pose compositions).
- Point removal: the same mask as the JAX package's, also on points
  placed 1e-5 to 3e-5 of the radius inside or outside it (the port
  squares the radius in float32, as the JAX package's jitted function
  does). Closer to the radius the verdict is the rounding's: XLA on the
  CPU fuses d2's squares into FMAs, and a few points within 3 float32
  steps of the radius came out the other way.
- Map assembly: the same voxel count and points within 1e-5 m, matched
  one to one as nearest neighbours (the port sums a voxel's points in
  float64, the JAX package in float32: a few ulp of ~30 m coordinates);
  a binary PCD either package writes, the other reads back bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu import config as jconfig
from mrg_slam_tpu.config import PrefilterConfig as JPrefilterConfig
from mrg_slam_tpu.config import RegistrationConfig as JRegistrationConfig
from mrg_slam_tpu.config import (
    ScanMatchingOdometryConfig as JScanMatchingOdometryConfig)
from mrg_slam_tpu.io.pcd import load_pcd as jload_pcd
from mrg_slam_tpu.io.pcd import save_pcd as jsave_pcd
from mrg_slam_tpu.models import odometry_fused as jfused
from mrg_slam_tpu.models.backend import (
    _remove_points_near as j_remove_points_near)
from mrg_slam_tpu.models.graph_database import GraphDatabase as JDatabase
from mrg_slam_tpu.models.map_cloud import MapCloudGenerator as JGenerator
from mrg_slam_tpu.ops import knn as jknn
from mrg_slam_tpu.ops import registration as jreg
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.ops.prefilter import prefilter as jprefilter

from mrg_slam_tpu_torch.config import (LoopClosureConfig, OptimizerConfig,
                                       SlamConfig)
from mrg_slam_tpu_torch.convert import carry_from_numpy, config_from_fields
from mrg_slam_tpu_torch.io.pcd import load_pcd, save_pcd
from mrg_slam_tpu_torch.io.synthetic import SyntheticWorld, circle_trajectory
from mrg_slam_tpu_torch.models import odometry_fused as fused
from mrg_slam_tpu_torch.models.backend import _remove_points_near
from mrg_slam_tpu_torch.models.graph_database import GraphDatabase
from mrg_slam_tpu_torch.models.map_cloud import MapCloudGenerator
from mrg_slam_tpu_torch.models.shared_graph import SharedGraphSlam
from mrg_slam_tpu_torch.ops import registration as reg
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.ops.covariance import GICPCloud
from mrg_slam_tpu_torch.utils import se3np

CAP, FRAMES = 256, 5
JCFG = JScanMatchingOdometryConfig(
    keyframe_delta_translation=2.0,
    registration=JRegistrationConfig(
        reg_transformation_epsilon=1e-3, reg_maximum_iterations=16,
        reg_covariance_mode="radius", reg_covariance_radius=1.0,
        reg_max_correspondence_distance=2.0),
    enable_transform_thresholding=True, max_acceptable_translation=2.5,
    max_acceptable_angle=0.5)
JPRE = JPrefilterConfig(downsample_resolution=0.5,
                        capacity_filtered_points=CAP,
                        outlier_removal_method="NONE")
CFG = config_from_fields(dataclasses.asdict(JCFG))
# the multi-chain store's config: constant edge information, so that a
# flush needs no fitness pass
JSLAM = jconfig.SlamConfig(
    own_name="alpha", multi_robot_names=("alpha", "bravo"),
    capacity_keyframes=16, capacity_edges=64, capacity_keyframe_points=64,
    inf_matrix=jconfig.InformationMatrixConfig(use_const_inf_matrix=True),
    robot_remove_points_radius=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: these tensors are small, and the suite's worker
    processes already share the machine's cores (threads then cost more
    in contention than they gain)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def robots():
    return make_robots()


def make_robots():
    """(points (2, F, CAP, 3), masks (2, F, CAP), stamps (2, F), true
    poses (2, F, 7)) as numpy: robot 0 fast along one arc, robot 1 slow
    along another."""
    w = SyntheticWorld.build(seed=9, extent=30.0, n_ground=20000,
                             n_pillars=20, n_walls=8,
                             max_points_per_scan=4096, noise=0.02)
    fast = circle_trajectory(60, radius=12.0, laps=1.0)[:FRAMES]
    slow = circle_trajectory(240, radius=12.0, laps=1.0)[120:120 + FRAMES]
    pts, masks = [], []
    for r, traj in enumerate((fast, slow)):
        cs = [jprefilter(JCloud.from_array(w.scan(p, seed=100 * r + i),
                                           4096), JPRE)
              for i, p in enumerate(traj)]
        pts.append(np.stack([np.asarray(c.points) for c in cs]))
        masks.append(np.stack([np.asarray(c.mask) for c in cs]))
    stamps = np.broadcast_to(np.arange(FRAMES, dtype=np.float32) * 0.1,
                             (2, FRAMES)).copy()
    return np.stack(pts), np.stack(masks), stamps, np.stack([fast, slow])


def exact_sqdist(src_chunk, tgt, tgt_mask):
    """The d2 of the JAX package's Pallas nn kernel, exact coordinate
    differences (pallas_nn.py:57-72), in place of its CPU path's
    |s|^2 + |t|^2 - 2 s.t (ROADMAP.md §3 B1)."""
    d = src_chunk[:, None, :] - tgt[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
        + d[..., 2] * d[..., 2]
    return jnp.where(tgt_mask[None, :], d2, jnp.inf)


@pytest.fixture
def exact_jax_nn(monkeypatch):
    """The JAX package's CPU nearest neighbours with `exact_sqdist`; its
    jit caches are dropped so that nothing traced before or here outlives
    the patch."""
    monkeypatch.setattr(jknn, "_chunk_sqdist", exact_sqdist)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _jax_covs(points, masks):
    return np.stack([np.asarray(jreg.make_source(
        JCloud(jnp.asarray(p), jnp.asarray(m)), JCFG.registration).covs)
        for p, m in zip(points, masks)])


def _port(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check_poses(got, want, tol_t, tol_q):
    np.testing.assert_allclose(got[..., :3], want[..., :3], rtol=0,
                               atol=tol_t)
    sign = np.sign((got[..., 3:] * want[..., 3:]).sum(-1, keepdims=True))
    np.testing.assert_allclose(got[..., 3:] * sign, want[..., 3:], rtol=0,
                               atol=tol_q)


def test_run_batch_multi_matches_jax(robots, exact_jax_nn, monkeypatch):
    pts, masks, stamps, _ = robots
    jcarries = jax.tree.map(lambda *x: jnp.stack(x),
                            *[jfused.init_carry(CAP) for _ in range(2)])
    _, jout = jfused.run_batch_multi(JCFG, jcarries, jnp.asarray(pts),
                                     jnp.asarray(masks), jnp.asarray(stamps))
    jkf = np.asarray(jout.is_new_keyframe)
    # one row switches keyframes where the other does not
    assert (jkf[0] & ~jkf[1]).any() and jkf[1, 1:].sum() < jkf[0, 1:].sum()

    def jax_covs(cloud, params):
        covs = _jax_covs(cloud.points.numpy(), cloud.mask.numpy())
        return GICPCloud(cloud.points, cloud.mask, torch.from_numpy(covs))

    monkeypatch.setattr(fused.reg, "make_source", jax_covs)
    carries = carry_from_numpy({k: np.asarray(v) for k, v in
                                jcarries._asdict().items()}, device="cpu")
    assert carries.target_points.shape == (2, CAP, 3)
    _, out = fused.run_batch_multi(CFG, carries, _port(pts), _port(masks),
                                   _port(stamps))
    assert out.pose.shape == (2, FRAMES, 7)
    np.testing.assert_array_equal(out.is_new_keyframe.numpy(), jkf)
    np.testing.assert_array_equal(out.num_inliers.numpy(),
                                  np.asarray(jout.num_inliers))
    _check_poses(out.pose.numpy(), np.asarray(jout.pose), 1e-4, 1e-4)


def test_rows_match_run_batch_alone(robots):
    """Both blocks: from fresh carries, then robot 0 continuing while
    robot 1 starts again from a fresh carry (its first frame in this
    block initializes its row alone)."""
    pts, masks, stamps = (_port(x) for x in robots[:3])
    carries = fused.stack_carries([fused.init_carry(CAP, device="cpu")
                                   for _ in range(2)])
    carries, out = fused.run_batch_multi(CFG, carries, pts, masks, stamps)
    alone = []
    for r in range(2):
        c_r, o_r = fused.run_batch(CFG, fused.init_carry(CAP, device="cpu"),
                                   pts[r], masks[r], stamps[r])
        alone.append((c_r, o_r))
        np.testing.assert_array_equal(out.is_new_keyframe[r].numpy(),
                                      o_r.is_new_keyframe.numpy())
        np.testing.assert_array_equal(out.iterations[r].numpy(),
                                      o_r.iterations.numpy())
        _check_poses(out.pose[r].numpy(), o_r.pose.numpy(), 1e-5, 1e-5)
    assert out.iterations.sum() > 0

    # block 2: robot 0 carries on, robot 1 restarts
    rows = fused.unstack_carries(carries)
    carries = fused.stack_carries([rows[0],
                                   fused.init_carry(CAP, device="cpu")])
    _, out2 = fused.run_batch_multi(CFG, carries, pts.flip(1), masks.flip(1),
                                    stamps + 1.0)
    _, a0 = fused.run_batch(CFG, alone[0][0], pts[0].flip(0),
                            masks[0].flip(0), stamps[0] + 1.0)
    _, a1 = fused.run_batch(CFG, fused.init_carry(CAP, device="cpu"),
                            pts[1].flip(0), masks[1].flip(0),
                            stamps[1] + 1.0)
    assert bool(out2.is_new_keyframe[1, 0])
    assert not bool(out2.is_new_keyframe[0, 0])
    np.testing.assert_array_equal(out2.pose[1, 0].numpy(),
                                  [0, 0, 0, 1, 0, 0, 0])
    for r, o_r in enumerate((a0, a1)):
        np.testing.assert_array_equal(out2.is_new_keyframe[r].numpy(),
                                      o_r.is_new_keyframe.numpy())
        _check_poses(out2.pose[r].numpy(), o_r.pose.numpy(), 1e-5, 1e-5)


def _mr_slam_config(names):
    regc = dataclasses.replace(CFG.registration, reg_stall_epsilon=0.01,
                               reg_coarse_stride=2, reg_coarse_iterations=6)
    return SlamConfig(
        own_name=names[0], multi_robot_names=tuple(names),
        keyframe_delta_trans=2.0, capacity_keyframes=16, capacity_edges=64,
        capacity_keyframe_points=CAP, registration=regc,
        optimizer=OptimizerConfig(solver_backend="dense",
                                  g2o_solver_num_iterations=16),
        loop=dataclasses.replace(LoopClosureConfig(), capacity_candidates=2,
                                 fitness_score_max_range=2.0,
                                 accum_distance_thresh_other_robot=2.0),
        robot_remove_points_radius=0.0)


def test_ragged_tail_falls_back_to_run_batch(robots):
    """bench.py's ingest loop (run_multirobot_scaling's `run`) at B = 3
    over windows of 5 and 4 frames: block 0 is one run_batch_multi, block
    1 falls back to per-robot run_batch for both robots (spans 2 and 1)."""
    pts, masks, stamps = (_port(x) for x in robots[:3])
    windows = {"alpha": (0, 5), "bravo": (0, 4)}
    names, B, R = list(windows), 3, 2
    cfg = _mr_slam_config(names)
    covs_ok = reg.covariance_compatible(CFG.registration, cfg.registration)
    group = SharedGraphSlam(cfg, names, device="cpu")
    carries = fused.stack_carries([fused.init_carry(CAP, device="cpu")
                                   for _ in names])
    fed = {n: [] for n in names}
    fallbacks = 0

    def ingest(name, s, fpts, fmask, poses, covs=None):
        for i in range(poses.shape[0]):
            fed[name].append(poses[i])
            group.process_scan(name, (s + i) * 0.1, poses[i],
                               PointCloud(fpts[i], fmask[i]),
                               source_covs=(covs[i] if covs is not None
                                            else None))

    n_local = max(hi - lo for lo, hi in windows.values())
    for s in range(0, n_local, B):
        spans = {n: (windows[n][0] + s,
                     min(windows[n][0] + s + B, windows[n][1]))
                 for n in names if s < windows[n][1] - windows[n][0]}
        if (len(spans) == len(names)
                and all(b - a == B for a, b in spans.values())):
            fpts = torch.stack([pts[r, a:b] for r, (a, b)
                                in enumerate(spans.values())])
            fmask = torch.stack([masks[r, a:b] for r, (a, b)
                                 in enumerate(spans.values())])
            st2 = stamps[:, s:s + B]
            carries, outs = fused.run_batch_multi(CFG, carries, fpts, fmask,
                                                  st2)
            all_poses = outs.pose.numpy()
            for r, name in enumerate(names):
                ingest(name, s, fpts[r], fmask[r], all_poses[r],
                       covs=(outs.covs[r] if covs_ok else None))
        else:
            rows = fused.unstack_carries(carries)
            for r, name in enumerate(names):
                if name not in spans:
                    continue
                a, b = spans[name]
                rows[r], outs = fused.run_batch(CFG, rows[r], pts[r, a:b],
                                                masks[r, a:b],
                                                stamps[r, s:s + (b - a)])
                fallbacks += 1
                ingest(name, s, pts[r, a:b], masks[r, a:b],
                       outs.pose.numpy(),
                       covs=(outs.covs if covs_ok else None))
            carries = fused.stack_carries(rows)
        group.optimization_tick(now=(s + B) * 0.1)
    group.optimization_tick(now=n_local * 0.1)

    assert fallbacks == 2
    for r, (name, (lo, hi)) in enumerate(windows.items()):
        _, whole = fused.run_batch(CFG, fused.init_carry(CAP, device="cpu"),
                                   pts[r, lo:hi], masks[r, lo:hi],
                                   stamps[r, lo:hi])
        _check_poses(np.stack(fed[name]), whole.pose.numpy(), 1e-4, 1e-4)
        kfs = group.robot_keyframes(name)
        assert kfs and all(k.node_id is not None for k in kfs)
        assert group.trajectory(name).shape == (len(kfs), 7)
    assert group.tick_stats and group.tick_stats[0].pair_buckets


def test_graph_database_multichain():
    """tests/test_shared_graph.py::test_graph_database_multichain through
    both packages: independent counters, one anchor per robot, odometry
    edges within each chain, each chain's odom->map applied."""
    rng = np.random.default_rng(0)
    clouds = [rng.uniform(-5, 5, size=(64, 3)).astype(np.float32)
              for _ in range(6)]
    stores = []
    for db, cloud in (
            (JDatabase(JSLAM), lambda p: JCloud.from_array(p, capacity=64)),
            (GraphDatabase(config_from_fields(dataclasses.asdict(JSLAM)),
                           device="cpu"),
             lambda p: PointCloud.from_array(p, capacity=64, device="cpu"))):
        for i in range(3):
            pose = se3np.pose_identity()
            pose[0] = float(i)
            db.add_odom_keyframe(i * 0.1, pose, float(i), cloud(clouds[i]),
                                 robot_name="alpha", slam_uuid="slam-a")
            pose_b = se3np.pose_identity()
            pose_b[1] = float(i)
            db.add_odom_keyframe(i * 0.1, pose_b, float(i),
                                 cloud(clouds[3 + i]), robot_name="bravo",
                                 slam_uuid="slam-b")
        o2m_b = se3np.pose_identity()
        o2m_b[0] = 10.0
        db.flush_keyframe_queue({"alpha": se3np.pose_identity(),
                                 "bravo": o2m_b})
        stores.append(db)

    jdb, db = stores
    assert db._odom_counters == jdb._odom_counters == {"alpha": 3,
                                                       "bravo": 3}
    assert db.odom_keyframe_counter == 3  # the own robot's view
    for name in ("alpha", "bravo"):
        assert db.prev_keyframe_of(name).robot_name == name
        assert db.prev_keyframe_of(name).odom_counter == 2
    assert db.prev_robot_keyframe is db.prev_keyframe_of("alpha")
    assert db.anchor_kf.robot_name == "alpha"
    assert db.anchor_edge.to_uuid == next(
        k.uuid for k in db.new_keyframes
        if k.robot_name == "alpha" and k.odom_counter == 0)
    for d in stores:
        assert sum(e.type == "anchor" for e in d.edges) == 2
        odo = [e for e in d.edges if e.type == "odom"]
        assert len(odo) == 4
        for e in odo:
            a = d.uuid_keyframe_map[e.from_uuid]
            b = d.uuid_keyframe_map[e.to_uuid]
            assert (a.robot_name, a.slam_uuid) == (b.robot_name, b.slam_uuid)
    assert [(e.type, e.from_readable, e.to_readable) for e in db.edges] == \
        [(e.type, e.from_readable, e.to_readable) for e in jdb.edges]
    est = np.stack([k.estimate(db.graph) for k in db.new_keyframes])
    jest = np.stack([k.estimate(jdb.graph) for k in jdb.new_keyframes])
    np.testing.assert_allclose(est, jest, rtol=0, atol=1e-5)
    kf_b0 = next(k for k in db.new_keyframes
                 if k.robot_name == "bravo" and k.odom_counter == 0)
    assert abs(kf_b0.estimate(db.graph)[0] - 10.0) < 1e-5


def test_remove_points_near_matches_jax():
    """Points on shells just inside and outside the radius around each
    center, an invalid center, masked points."""
    rng = np.random.default_rng(4)
    centers = rng.uniform(-10, 10, (8, 3)).astype(np.float32)
    valid = np.array([1, 1, 1, 0, 1, 0, 0, 0], bool)
    r = np.float32(2.0)
    v = rng.normal(size=(8, 64, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    scale = r * (1 + rng.choice([-3, -2, -1, 1, 2, 3], (8, 64, 1)) * 1e-5)
    pts = (centers[:, None] + scale * v).reshape(-1, 3).astype(np.float32)
    pts = np.concatenate([pts, rng.uniform(-12, 12, (512, 3))]).astype(
        np.float32)
    mask = rng.random(len(pts)) > 0.1
    want = np.asarray(j_remove_points_near(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(centers),
        jnp.asarray(valid), jnp.float32(r)))
    got = _remove_points_near(torch.from_numpy(pts), torch.from_numpy(mask),
                              torch.from_numpy(centers),
                              torch.from_numpy(valid), float(r)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (~got & mask).sum() > 50


def _same_map(got, want, least=100):
    """The same number of voxels, each point of one map within 1e-5 of
    its own point of the other (nearest neighbours, one to one)."""
    from scipy.spatial import cKDTree

    assert got.shape == want.shape and len(got) >= least
    dist, idx = cKDTree(want.astype(np.float64)).query(got)
    assert dist.max() <= 1e-5
    assert len(np.unique(idx)) == len(got)


@pytest.mark.parametrize("min_points,far,chunk,least",
                         [(1, 1e4, 64, 100), (1, 8.0, 4, 100),
                          (2, 1e4, 4, 10)])
def test_map_generator_matches_jax(robots, tmp_path, min_points, far, chunk,
                                   least):
    """Both robots' ten clouds at their true poses, each robot's first
    one skipped; chunks of 64 (one) and of 4 (three, the re-voxelization
    joining them: with min_points 2 a voxel stays where two chunks' maps
    share it)."""
    pts, masks, _, poses = (x.reshape((-1,) + x.shape[2:]) for x in robots)
    first = [i % FRAMES == 0 for i in range(len(pts))]
    args = (0.5, min_points, far)
    got = MapCloudGenerator(*args, keyframes_per_chunk=chunk).generate(
        [PointCloud(_port(p), _port(m)) for p, m in zip(pts, masks)],
        poses, first_flags=first)
    want = JGenerator(*args, keyframes_per_chunk=chunk).generate(
        [JCloud(jnp.asarray(p), jnp.asarray(m)) for p, m in zip(pts, masks)],
        poses, first_flags=first)
    _same_map(got, want, least)
    # a binary PCD either package writes, the other reads back bit for bit
    save_pcd(tmp_path / "t.pcd", got)
    np.testing.assert_array_equal(jload_pcd(tmp_path / "t.pcd"), got)
    jsave_pcd(tmp_path / "j.pcd", want)
    np.testing.assert_array_equal(load_pcd(tmp_path / "j.pcd"), want)
