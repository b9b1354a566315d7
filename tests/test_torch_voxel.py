"""The port's voxel-target registration family (FAST_VGICP, NDT) against
the JAX package's, on the same numpy inputs: the Gaussian voxel map and
its lookups, `align`, the pair program through `PairRunner`, and a few
frames of the per-frame `ScanMatchingOdometry` with NDT.

Tolerances and why:
- The map's keys, counts, valid flags and origin: bitwise (int32 keys,
  the same stable sort on (scrambled key, key), integer counts).
- Its means: within 1e-5 m (the port sums in float64 and rounds, the JAX
  package sums in float32). Its covariances, in cells of at least 4
  points whose normal is well posed (a gap above 0.05 between the two
  smallest eigenvalues), within 1e-3: the raw float32 second moments
  differ by that rounding, which tilts each cell's normal and so its
  plane-regularized covariance (as tests/test_torch_ops.py bounds the
  radius covariances). A cell of fewer points, or one where two planes
  meet, has no well-posed normal, and either package takes it from
  rounding noise.
- Lookups at DIRECT1/7/27: equal indices and found flags (a probe's
  distance to a mean differs by rounding only, and ties go to the first
  probe in both).
- align, end to end (each package its own map and covariances): within
  5e-3 m / 5e-3 rad of each other, the bound of the port's GICP align
  parity (tests/test_torch_ops.py), and within the JAX package's own
  bounds of the truth (tests/test_registration.py: 0.10 m / 0.02 rad for
  VGICP, 0.05 m / 0.01 rad for NDT). Given the JAX package's map and
  source covariances, the Gauss-Newton agrees to 1e-4 with the same
  iteration count and converged flag.
- PairRunner: the registration row within 5e-3 m of the JAX package's
  row and 0.15 m of the truth (tests/test_registration.py), the same
  converged flag, the evaluate-only row's pose untouched, fitness within
  1e-4 m^2 + 1e-3 relative.
- ScanMatchingOdometry with NDT over 6 frames: equal keyframe flags and
  poses within 2.5 cm / 0.01 on quaternion components, the short-run
  bound of tests/test_torch_scan_odometry.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.config import RegistrationConfig as JRegistrationConfig
from mrg_slam_tpu.config import \
    ScanMatchingOdometryConfig as JScanMatchingOdometryConfig
from mrg_slam_tpu.io.synthetic import SyntheticWorld, circle_trajectory
from mrg_slam_tpu.models.keyframe import KeyFrame as JKeyFrame
from mrg_slam_tpu.models.odometry import \
    ScanMatchingOdometry as JScanMatchingOdometry
from mrg_slam_tpu.models.pair_runner import PairRequest as JPairRequest
from mrg_slam_tpu.models.pair_runner import PairRunner as JPairRunner
from mrg_slam_tpu.ops import gaussian_voxel as jgv
from mrg_slam_tpu.ops import registration as jreg
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.utils import se3 as jse3

from mrg_slam_tpu_torch.config import PrefilterConfig
from mrg_slam_tpu_torch.convert import config_from_fields, voxel_map_from_numpy
from mrg_slam_tpu_torch.models.keyframe import KeyFrame
from mrg_slam_tpu_torch.models.odometry import ScanMatchingOdometry
from mrg_slam_tpu_torch.models.pair_runner import PairRequest, PairRunner
from mrg_slam_tpu_torch.ops import gaussian_voxel as tgv
from mrg_slam_tpu_torch.ops import registration as treg
from mrg_slam_tpu_torch.ops import voxel as tvox
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.ops.prefilter import prefilter
from mrg_slam_tpu_torch.utils import se3 as tse3

from test_registration import structured_scene, true_pose
from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)

IDENT = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jparams(method):
    """tests/test_registration.py's parameters for the scene."""
    return JRegistrationConfig(registration_method=method,
                               reg_transformation_epsilon=1e-4,
                               reg_maximum_iterations=64,
                               reg_resolution=2.0,
                               reg_max_correspondence_distance=2.0)


def _tparams(jp):
    return config_from_fields(dataclasses.asdict(jp))


def _maps(pts, min_points):
    jm = jgv.build_gaussian_voxel_map(JCloud.from_array(pts, 2048), 2.0,
                                      2048, min_points=min_points)
    tm = tgv.build_gaussian_voxel_map(
        PointCloud.from_array(pts, 2048, device="cpu"), 2.0, 2048,
        min_points=min_points)
    return jm, tm


def _normal_gaps(points, tm, resolution):
    """Per slot of the map, the gap between the two smallest eigenvalues
    of its cell's covariance in float64 (0 for an empty slot): the
    normal is well posed where the gap is wide."""
    key = tvox.pack_key(tvox.voxel_coords(_t(points), resolution,
                                          tm.origin), torch.ones(
        len(points), dtype=torch.bool)).numpy()
    gaps = np.zeros(tm.keys.shape[0])
    for slot, k in enumerate(tm.keys.numpy()):
        cell = points[key == k].astype(np.float64)
        if tm.valid[slot] and len(cell) >= 3:
            w = np.linalg.eigvalsh(np.cov(cell.T, bias=True))
            gaps[slot] = w[1] - w[0]
    return gaps


def check_map(jm, tm, points=None, resolution=None):
    """tm holds jm's voxels in jm's slots (the bounds above; covariances
    where a cell has at least 4 points and, given the cloud, an
    eigenvalue gap above 0.05 under its normal)."""
    for f in ("keys", "counts", "valid", "origin"):
        assert np.array_equal(getattr(tm, f).numpy(),
                              np.asarray(getattr(jm, f))), f
    np.testing.assert_allclose(tm.means.numpy(), np.asarray(jm.means),
                               rtol=0, atol=1e-5)
    well_posed = tm.valid.numpy() & (tm.counts.numpy() >= 4)
    if points is not None:
        well_posed &= _normal_gaps(points, tm, resolution) > 0.05
    assert well_posed.sum() >= 10
    np.testing.assert_allclose(tm.covs.numpy()[well_posed],
                               np.asarray(jm.covs)[well_posed], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("min_points", [1, 4], ids=["vgicp", "ndt"])
def test_voxel_map_matches_jax(rng, min_points):
    pts = structured_scene(rng)
    jm, tm = _maps(pts, min_points)
    assert 100 < int(tm.valid.sum()) < 2048
    check_map(jm, tm, pts, 2.0)
    # a batch of clouds builds each row's own map
    pts = structured_scene(rng)
    both = tgv.build_gaussian_voxel_map(PointCloud(
        torch.stack([PointCloud.from_array(p, 2048, device="cpu").points
                     for p in (pts, pts[::2])]),
        torch.stack([PointCloud.from_array(p, 2048, device="cpu").mask
                     for p in (pts, pts[::2])])), 2.0, 2048, min_points)
    for i, p in enumerate((pts, pts[::2])):
        one = tgv.build_gaussian_voxel_map(
            PointCloud.from_array(p, 2048, device="cpu"), 2.0, 2048,
            min_points)
        for a, b in zip(both, one):
            assert torch.equal(a[i], b)


@pytest.mark.parametrize("method", ["DIRECT1", "DIRECT7", "DIRECT27"])
def test_lookup_matches_jax(rng, method):
    pts = structured_scene(rng)
    jm, _ = _maps(pts, 4)
    tm = voxel_map_from_numpy(jm, device="cpu")
    q = pts + rng.normal(scale=0.7, size=pts.shape).astype(np.float32)
    mask = np.ones(len(q), bool)
    mask[::7] = False
    ji, jf = jax.jit(jgv.lookup, static_argnums=(3, 4))(
        jm, jnp.asarray(q), jnp.asarray(mask), 2.0, method)
    ti, tf = tgv.lookup(tm, _t(q), _t(mask), 2.0, method)
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert not tf.numpy()[~mask].any() and tf.numpy()[mask].mean() > 0.5


@pytest.mark.parametrize("method", ["FAST_VGICP", "NDT"])
def test_align_matches_jax(rng, method):
    pts = structured_scene(rng)
    gt = true_pose()
    src = np.asarray(jse3.pose_apply(jse3.pose_inverse(gt),
                                     jnp.asarray(pts)))
    jp = _jparams(method)
    tp = _tparams(jp)
    jsrc = jreg.make_source(JCloud.from_array(src, 2048), jp)
    jtgt = jreg.make_target(JCloud.from_array(pts, 2048), jp)
    jres = jreg.align(jp, jsrc, jtgt, jse3.pose_identity())
    tsrc = treg.make_source(PointCloud.from_array(src, 2048, device="cpu"),
                            tp)
    ttgt = treg.make_target(PointCloud.from_array(pts, 2048, device="cpu"),
                            tp)
    assert ttgt.gicp is None and ttgt.voxels is not None
    tres = treg.align(tp, tsrc, ttgt, tse3.pose_identity())
    jpose, tpose, gtn = np.asarray(jres.pose), tres.pose.numpy(), \
        np.asarray(gt)
    tol_t, tol_r = (0.10, 0.02) if method == "FAST_VGICP" else (0.05, 0.01)
    assert np.linalg.norm(tpose[:3] - gtn[:3]) < tol_t
    assert float(tse3.rotation_angle(tse3.pose_between(
        _t(gtn), _t(tpose))[3:])) < tol_r
    assert np.linalg.norm(tpose[:3] - jpose[:3]) < 5e-3
    assert float(tse3.rotation_angle(tse3.pose_between(
        _t(jpose), _t(tpose))[3:])) < 5e-3
    assert int(tres.num_inliers) > 500

    # the same map and source covariances: the Gauss-Newton core agrees
    shared = treg.align(tp, tsrc._replace(covs=_t(np.asarray(jsrc.covs))),
                        treg.RegistrationTarget(voxels=voxel_map_from_numpy(
                            jtgt.voxels, device="cpu")),
                        tse3.pose_identity())
    np.testing.assert_allclose(shared.pose.numpy(), jpose, atol=1e-4)
    assert int(shared.iterations) == int(jres.iterations)
    assert bool(shared.converged) == bool(jres.converged)
    assert abs(int(shared.num_inliers) - int(jres.num_inliers)) <= 2


@pytest.mark.parametrize("method", ["FAST_VGICP", "NDT"])
def test_pair_runner_voxel_methods_match_jax(rng, method):
    """tests/test_registration.py's `test_pair_runner_voxel_methods` scene
    through both packages' PairRunner: a registration row and an
    evaluate-only row in one bucket."""
    pts = structured_scene(rng, n=900)
    gt = true_pose()
    src = np.asarray(jse3.pose_apply(jse3.pose_inverse(gt),
                                     jnp.asarray(pts)))
    jp = _jparams(method)

    def jkf(p):
        k = JKeyFrame.__new__(JKeyFrame)
        k.cloud = JCloud.from_array(p, capacity=1024)
        return k

    def tkf(p):
        return KeyFrame(robot_name="r", stamp=0.0, odom=IDENT,
                        accum_distance=0.0,
                        cloud=PointCloud.from_array(p, 1024, device="cpu"))

    def requests(kf, req):
        t, s = kf(pts), kf(src)
        return [req(target=t, source=s, init_pose=IDENT,
                    max_iters=jp.reg_maximum_iterations,
                    fitness_max_range=2.0),
                req(target=t, source=t, init_pose=IDENT)]

    jrows = JPairRunner(jp).run(requests(jkf, JPairRequest))
    runner = PairRunner(_tparams(jp))
    assert runner.voxel_target
    treqs = requests(tkf, PairRequest)
    runner.prefetch_batch([treqs[0].target, treqs[0].source])
    assert treqs[0].target.voxel_map is not None
    trows = runner.run(treqs)
    (reg_row, eval_row), (jreg_row, jeval_row) = trows, jrows
    assert np.linalg.norm(reg_row.pose[:3] - np.asarray(gt)[:3]) < 0.15
    assert np.linalg.norm(reg_row.pose[:3] - jreg_row.pose[:3]) < 5e-3
    assert reg_row.converged == jreg_row.converged
    assert reg_row.num_inliers > 500
    np.testing.assert_array_equal(eval_row.pose, IDENT)
    for a, b in ((reg_row, jreg_row), (eval_row, jeval_row)):
        for f in ("fitness_inf", "fitness_range"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-3, atol=1e-4)
    assert eval_row.fitness_inf < 1e-6


def test_pair_runner_pads_maps_of_two_capacities(rng):
    """A bucket whose keyframes' maps have different capacities (a filled
    first keyframe's cloud is larger) runs as the maps alone do: the
    smaller map is padded with invalid keys, which no lookup finds."""
    pts = structured_scene(rng, n=900)
    tp = _tparams(_jparams("NDT"))

    def kf(cap):
        return KeyFrame(robot_name="r", stamp=0.0, odom=IDENT,
                        accum_distance=0.0,
                        cloud=PointCloud.from_array(pts, cap, device="cpu"))

    big, small = kf(2048), kf(1024)
    runner = PairRunner(tp)
    pose = np.asarray(jse3.pose_exp(jnp.asarray(
        [0.2, 0.1, 0.0, 0.0, 0.0, 0.02], jnp.float32)))
    req = [PairRequest(target=t, source=small, init_pose=pose,
                       max_iters=16) for t in (big, small)]
    both = runner.run(req)
    alone = [runner.run([r])[0] for r in req]
    assert runner.voxel_map(big).keys.shape[0] == 2048
    for a, b in zip(both, alone):
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-5)
        assert a.iterations == b.iterations


def test_scan_odometry_ndt_matches_jax(one_thread):
    """Six frames of the per-frame front end with NDT (DIRECT7), the same
    prefiltered clouds fed to both packages."""
    world = SyntheticWorld.build(seed=9, extent=30.0, n_ground=20000,
                                 max_points_per_scan=2048, noise=0.01)
    traj = circle_trajectory(6, radius=10.0, laps=0.05)
    pre = PrefilterConfig(downsample_resolution=0.6,
                          capacity_raw_points=2048,
                          capacity_filtered_points=512,
                          outlier_removal_method="NONE")
    clouds = []
    for i, p in enumerate(traj):
        c = prefilter(PointCloud.from_array(world.scan(p, seed=i), 2048,
                                            device="cpu"), pre)
        clouds.append((c.points.numpy(), c.mask.numpy()))
    jcfg = JScanMatchingOdometryConfig(
        keyframe_delta_translation=1.0,
        registration=JRegistrationConfig(registration_method="NDT",
                                         reg_resolution=1.0,
                                         reg_transformation_epsilon=1e-3,
                                         reg_maximum_iterations=32))
    jodom = JScanMatchingOdometry(jcfg)
    todom = ScanMatchingOdometry(config_from_fields(
        dataclasses.asdict(jcfg)))
    jout, tout = [], []
    for i, (p, m) in enumerate(clouds):
        jout.append(jodom.step(JCloud(jnp.asarray(p), jnp.asarray(m)),
                               stamp=i * 0.1))
        tout.append(todom.step(PointCloud(_t(p), _t(m)), stamp=i * 0.1))
    assert todom._target.voxels is not None
    assert [o.is_new_keyframe for o in tout] == [
        bool(o.is_new_keyframe) for o in jout]
    got = np.stack([o.pose for o in tout])
    want = np.stack([np.asarray(o.pose) for o in jout])
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=0.025)
    sign = np.sign((got[:, 3:] * want[:, 3:]).sum(-1, keepdims=True))
    np.testing.assert_allclose(got[:, 3:] * sign, want[:, 3:], rtol=0,
                               atol=0.01)
    assert [o.status.has_converged for o in tout] == [
        bool(o.status.has_converged) for o in jout]
