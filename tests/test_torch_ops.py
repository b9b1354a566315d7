"""The port's ops against the JAX package's, on the same numpy inputs.

Tolerances and why:
- se3, sym3eig, inv3x3: 1e-5 (the same float32 formulas; transcendental
  and reduction rounding differ between the two libraries by a few ulp).
- scramble_key, wrapped/packed keys: bitwise (int32 arithmetic).
- voxel_downsample: the same voxels in the same lanes, means within
  1e-5 m (the port sums in float64, the reference in float32).
- prefilter: RADIUS outlier masks differ on at most 3 points: the
  reference's CPU path counts neighbours through |s|^2 + |t|^2 - 2 s.t,
  whose rounding moves pairs near the radius (ROADMAP.md §3 fault 1);
  the port counts from exact differences.
- estimate_covariances_radius: the raw covariances agree with float64
  within the float32 summation bound (tol_raw), and the regularized ones
  within the bound that error puts on the normal (12 tol_raw / gap), which
  is under 1e-3 wherever the normal is well posed (gap > 0.05). A
  neighbourhood without a unique normal (a few nearly collinear points)
  takes its normal from rounding noise in either package.
- align: with the same covariances, poses within 1e-4 and the same
  iteration count and converged flag (also with the stall exit, the coarse
  stage and reciprocal correspondences on); end to end (each package its
  own covariances) within 5e-3 m / 5e-3 rad of each other and 0.05 m of
  the truth, as the reference's own test asks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.config import PrefilterConfig as JPrefilterConfig
from mrg_slam_tpu.config import RegistrationConfig as JRegistrationConfig
from mrg_slam_tpu.ops import covariance as jcov
from mrg_slam_tpu.ops import prefilter as jpre
from mrg_slam_tpu.ops import registration as jreg
from mrg_slam_tpu.ops import sym3eig as jsym
from mrg_slam_tpu.ops import voxel as jvox
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.utils import se3 as jse3

from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.ops import covariance as tcov
from mrg_slam_tpu_torch.ops import prefilter as tpre
from mrg_slam_tpu_torch.ops import registration as treg
from mrg_slam_tpu_torch.ops import stats_kernel, sym3eig as tsym
from mrg_slam_tpu_torch.ops import voxel as tvox
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.utils import se3 as tse3

U32 = 2.0 ** -24


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _poses(rng, n):
    xi = rng.normal(scale=[2, 2, 2, 0.8, 0.8, 0.8], size=(n, 6))
    xi[:4, 3:] *= 1e-4  # small-angle branch
    return np.asarray(jse3.pose_exp(jnp.asarray(xi, jnp.float32))), xi


def test_se3_matches_jax(rng):
    a, xi = _poses(rng, 16)
    b, _ = _poses(rng, 16)
    pts = rng.uniform(-45, 45, size=(16, 3)).astype(np.float32)
    ta, tb = _t(a), _t(b)
    pairs = [
        (tse3.pose_compose(ta, tb), jse3.pose_compose(a, b)),
        (tse3.pose_inverse(ta), jse3.pose_inverse(a)),
        (tse3.pose_between(ta, tb), jse3.pose_between(a, b)),
        (tse3.pose_apply(ta, _t(pts)), jse3.pose_apply(a, pts)),
        (tse3.pose_exp(_t(xi.astype(np.float32))),
         jse3.pose_exp(xi.astype(np.float32))),
        (tse3.pose_retract(ta, _t(xi.astype(np.float32))),
         jse3.pose_retract(a, xi.astype(np.float32))),
        (tse3.pose_rotation(ta), jse3.pose_rotation(a)),
        (tse3.so3_exp(_t(xi[:, 3:].astype(np.float32))),
         jse3.so3_exp(xi[:, 3:].astype(np.float32))),
        (tse3.skew(_t(pts)), jse3.skew(pts)),
        (tse3.mat_to_quat(tse3.quat_to_mat(ta[:, 3:])),
         jse3.mat_to_quat(jse3.quat_to_mat(a[:, 3:]))),
        (tse3.rotation_angle(ta[:, 3:]), jse3.rotation_angle(a[:, 3:])),
        (tse3.rotation_angle(tse3.pose_rotation(ta)),
         jse3.rotation_angle(jse3.pose_rotation(a))),
    ]
    for i, (got, want) in enumerate(pairs):
        # 45 m points rotate to 1e-5 relative
        np.testing.assert_allclose(_n(got), _n(want), rtol=1e-5, atol=1e-5,
                                   err_msg=f"case {i}")


def _sym(rng, n):
    A = rng.normal(size=(n, 3, 3))
    S = A @ A.transpose(0, 2, 1)
    S[:8] = np.diag([1.0, 0.05, 1e-4])  # plane-like, as GICP sees it
    R = np.asarray(jse3.quat_to_mat(jse3.quat_normalize(
        jnp.asarray(rng.normal(size=(8, 4)), jnp.float32))))
    S[:8] = R @ S[:8] @ R.transpose(0, 2, 1)
    return S.astype(np.float32)


def test_sym3eig_and_inv3x3_match_jax(rng):
    S = _sym(rng, 64)
    w_t, v_t = tsym.smallest_eigvec3(_t(S))
    w_j, v_j = jsym.smallest_eigvec3(jnp.asarray(S))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5,
                               atol=1e-5)
    # eigenvectors up to sign
    dot = np.abs((v_t.numpy() * np.asarray(v_j)).sum(-1))
    np.testing.assert_allclose(dot, 1.0, atol=1e-5)
    np.testing.assert_allclose(tsym.eigvalsh3(_t(S)).numpy(),
                               np.asarray(jsym.eigvalsh3(jnp.asarray(S))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tcov.inv3x3(_t(S)).numpy(),
                               np.asarray(jcov.inv3x3(jnp.asarray(S))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tcov.regularize_covs_plane(_t(S)).numpy(),
        np.asarray(jcov.regularize_covs_plane(jnp.asarray(S))), atol=1e-5)


def test_scramble_key_bitwise(rng):
    keys = rng.integers(0, 2 ** 30, size=4096, dtype=np.int64)
    edge = [0, 1, 2, 2 ** 30 - 1, 2 ** 31 - 2, 2 ** 31 - 1, -1, -2 ** 31,
            1640531527, 1309, 2 ** 20, 12345678]
    keys = np.concatenate([keys, edge]).astype(np.int32)
    got = tvox.scramble_key(_t(keys)).numpy()
    want = np.asarray(jvox.scramble_key(jnp.asarray(keys)))
    np.testing.assert_array_equal(got, want)
    # the multiply wraps (the reference relies on it), and the invalid key
    # keeps the top slot
    assert (keys.astype(np.int64) * -1640531527 != (
        keys * np.int32(-1640531527)).astype(np.int64)).any()
    assert got[len(keys) - len(edge) + 5] == 2 ** 31 - 1


def test_voxel_keys_bitwise(rng):
    pts = rng.uniform(-60, 60, size=(2048, 3)).astype(np.float32)
    valid = rng.random(2048) > 0.1
    np.testing.assert_array_equal(
        tvox.wrapped_key(_t(pts), _t(valid), 0.3).numpy(),
        np.asarray(jvox.wrapped_key(jnp.asarray(pts), jnp.asarray(valid),
                                    0.3)))
    coords = rng.integers(-5, 1030, size=(2048, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tvox.pack_key(_t(coords), _t(valid)).numpy(),
        np.asarray(jvox.pack_key(jnp.asarray(coords), jnp.asarray(valid))))


def _scan(rng, n=2048):
    """A LiDAR-like patch 8-32 m out: ground, a wall, sparse clutter."""
    g = np.stack([rng.uniform(8, 32, n // 2), rng.uniform(-12, 12, n // 2),
                  rng.normal(-1.5, 0.02, n // 2)], 1)
    w = np.stack([rng.uniform(8, 32, n // 4),
                  8 + rng.normal(0, 0.02, n // 4),
                  rng.uniform(-1.5, 2, n // 4)], 1)
    c = np.stack([rng.uniform(8, 32, n - n // 2 - n // 4),
                  rng.uniform(-12, 12, n - n // 2 - n // 4),
                  rng.uniform(-1.5, 4, n - n // 2 - n // 4)], 1)
    return np.concatenate([g, w, c]).astype(np.float32)


@pytest.mark.parametrize("absolute_origin,capacity", [(True, 1024),
                                                      (False, 1024),
                                                      (True, 256)])
def test_voxel_downsample_matches_jax(rng, absolute_origin, capacity):
    pts = _scan(rng)
    jc = jvox.voxel_downsample(JCloud.from_array(pts, 2048), 1.0,
                               min_points=1, capacity=capacity,
                               absolute_origin=absolute_origin)
    tc = tvox.voxel_downsample(PointCloud.from_array(pts, 2048,
                                                     device="cpu"), 1.0,
                               min_points=1, capacity=capacity,
                               absolute_origin=absolute_origin)
    jm = np.asarray(jc.mask)
    np.testing.assert_array_equal(tc.mask.numpy(), jm)
    np.testing.assert_allclose(tc.points.numpy()[jm], np.asarray(
        jc.points)[jm], rtol=0, atol=1e-5)
    assert (tc.points.numpy()[~jm] == 1e6).all()


def test_voxel_downsample_min_points(rng):
    pts = _scan(rng)
    jc = jvox.voxel_downsample(JCloud.from_array(pts, 2048), 1.0,
                               min_points=3, capacity=1024)
    tc = tvox.voxel_downsample(PointCloud.from_array(pts, 2048,
                                                     device="cpu"), 1.0,
                               min_points=3, capacity=1024)
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))


def _pre_cfgs(**kw):
    j = JPrefilterConfig(downsample_resolution=0.4,
                         capacity_filtered_points=1024, **kw)
    return j, config_from_fields(dataclasses.asdict(j))


@pytest.mark.parametrize("method", ["RADIUS", "NONE"])
def test_prefilter_matches_jax(rng, method):
    pts = _scan(rng)
    jcfg, tcfg = _pre_cfgs(outlier_removal_method=method, radius_radius=1.0)
    jc = jpre.prefilter(JCloud.from_array(pts, 2048), jcfg)
    tc = tpre.prefilter(PointCloud.from_array(pts, 2048, device="cpu"), tcfg)
    jm, tm = np.asarray(jc.mask), tc.mask.numpy()
    assert (jm != tm).sum() <= 3, (jm != tm).sum()
    both = jm & tm
    assert both.sum() > 500
    np.testing.assert_allclose(tc.points.numpy()[both],
                               np.asarray(jc.points)[both], atol=1e-5)
    d = tpre.distance_filter(PointCloud.from_array(pts, 2048, device="cpu"),
                             0.1, 30.0)
    jd = jpre.distance_filter(JCloud.from_array(pts, 2048), 0.1, 30.0)
    np.testing.assert_array_equal(d.mask.numpy(), np.asarray(jd.mask))


def test_prefilter_later_stages_raise(rng):
    pts = PointCloud.from_array(_scan(rng), 2048, device="cpu")
    _, stat = _pre_cfgs(outlier_removal_method="STATISTICAL")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpre.prefilter(pts, stat)
    _, desk = _pre_cfgs(enable_deskewing=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpre.prefilter(pts, desk, ang_vel=torch.zeros(3),
                       point_time_frac=torch.zeros(2048))


def test_estimate_covariances_radius_matches_jax(rng):
    pts = _scan(rng)
    jcfg, tcfg = _pre_cfgs(outlier_removal_method="NONE")
    c = jpre.prefilter(JCloud.from_array(pts, 2048), jcfg)
    P, M = np.asarray(c.points), np.asarray(c.mask)
    jg = jcov.estimate_covariances_radius(c, radius=1.0)
    tg = tcov.estimate_covariances_radius(PointCloud(_t(P), _t(M)), 1.0)

    padded = np.where(M[:, None], P, np.float32(1e6))
    mo = stats_kernel.moments_plain(_t(padded)[None], _t(padded)[None],
                                    stats_kernel.radius_sq(1.0))[0]
    cnt, _, cov = (v.numpy() for v in stats_kernel.moments_to_mean_cov(mo))
    p64 = P[M].astype(np.float64)
    d = ((p64[:, None] - p64[None]) ** 2).sum(-1)
    w = (d <= 1.0).astype(np.float64)
    np.testing.assert_array_equal(cnt[M], w.sum(1))
    mean64 = w @ p64 / w.sum(1)[:, None]
    cov64 = np.einsum("ct,ta,tb->cab", w, p64, p64) / w.sum(1)[:, None, None] \
        - mean64[:, :, None] * mean64[:, None, :]
    x = np.abs(p64).max()
    n = w.sum(1).max()
    tol_raw = 2 * n * U32 * x * x * 3
    np.testing.assert_allclose(cov[M], cov64, rtol=0, atol=tol_raw)

    # regularized: I - (1-eps) n n^T moves with the normal n, which a
    # covariance error d turns by at most ~3 d / gap (Davis-Kahan; gap =
    # the two smallest eigenvalues' distance). Both packages are within
    # tol_raw of float64, so their normals differ by at most 6 tol_raw /
    # gap and the matrices by twice that.
    ev = np.linalg.eigvalsh(cov64)
    gap = np.maximum(ev[:, 1] - ev[:, 0], 1e-12)
    diff = np.abs(tg.covs.numpy()[M] - np.asarray(jg.covs)[M]).max((1, 2))
    ok = diff <= np.minimum(12 * tol_raw / gap, 2.0) + 1e-5
    assert ok[w.sum(1) >= 3].all()
    assert (diff[(w.sum(1) >= 3) & (gap > 0.05)] < 1e-3).all()
    eye = np.eye(3, dtype=np.float32)
    assert (tg.covs.numpy()[~M] == eye).all()
    assert (tg.covs.numpy()[M][w.sum(1) < 3] == eye).all()


def _three_planes(rng, n=500):
    floor = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                      rng.normal(scale=0.02, size=n)], 1)
    wall = np.stack([rng.uniform(-10, 10, n),
                     10 + rng.normal(scale=0.02, size=n),
                     rng.uniform(0, 4, n)], 1)
    wall2 = np.stack([-10 + rng.normal(scale=0.02, size=n),
                      rng.uniform(-10, 10, n), rng.uniform(0, 4, n)], 1)
    return np.concatenate([floor, wall, wall2]).astype(np.float32)


# the stall exit, the coarse stage and reciprocal correspondences at once:
# an update epsilon out of reach leaves the stall exit to end the solve
_STALL_COARSE_RECIPROCAL = dict(reg_transformation_epsilon=1e-9,
                                reg_stall_epsilon=1e-3, reg_coarse_stride=2,
                                reg_coarse_iterations=4,
                                reg_use_reciprocal_correspondences=True)


@pytest.mark.parametrize(
    "method,opts", [("SMALL_GICP", {}), ("ICP", {}),
                    ("SMALL_GICP", _STALL_COARSE_RECIPROCAL)],
    ids=["SMALL_GICP", "ICP", "SMALL_GICP-stall-coarse-reciprocal"])
def test_align_three_planes_matches_jax(rng, method, opts):
    pts = _three_planes(rng)
    gt = jse3.pose_exp(jnp.asarray([0.3, -0.2, 0.1, 0.02, 0.03, -0.05],
                                   dtype=jnp.float32))
    src = np.asarray(jse3.pose_apply(jse3.pose_inverse(gt),
                                     jnp.asarray(pts)))
    jp = JRegistrationConfig(**{**dict(registration_method=method,
                                       reg_covariance_mode="radius",
                                       reg_covariance_radius=1.0,
                                       reg_transformation_epsilon=1e-4),
                                **opts})
    tp = config_from_fields(dataclasses.asdict(jp))
    jsrc = jreg.make_source(JCloud.from_array(src, 2048), jp)
    jtgt = jreg.make_target(JCloud.from_array(pts, 2048), jp)
    jres = jreg.align(jp, jsrc, jtgt, jse3.pose_identity())
    tsrc = treg.make_source(PointCloud.from_array(src, 2048, device="cpu"),
                            tp)
    ttgt = treg.make_target(PointCloud.from_array(pts, 2048, device="cpu"),
                            tp)
    ident = tse3.pose_identity()
    tres = treg.align(tp, tsrc, ttgt, ident)
    jpose, tpose, gtn = np.asarray(jres.pose), tres.pose.numpy(), \
        np.asarray(gt)
    assert np.linalg.norm(tpose[:3] - gtn[:3]) < 0.05
    assert np.linalg.norm(tpose[:3] - jpose[:3]) < 5e-3
    ang = float(tse3.rotation_angle(tse3.pose_between(
        _t(jpose), _t(tpose))[3:]))
    assert ang < 5e-3
    assert bool(tres.converged) == bool(jres.converged)

    # the same covariances: the Gauss-Newton core agrees to 1e-4
    shared_src = tsrc._replace(covs=_t(np.asarray(jsrc.covs)))
    shared_tgt = treg.RegistrationTarget(gicp=ttgt.gicp._replace(
        covs=_t(np.asarray(jtgt.gicp.covs))))
    sres = treg.align(tp, shared_src, shared_tgt, ident)
    np.testing.assert_allclose(sres.pose.numpy(), jpose, atol=1e-4)
    assert int(sres.iterations) == int(jres.iterations)
    assert abs(int(sres.num_inliers) - int(jres.num_inliers)) <= 2
    np.testing.assert_allclose(sres.hessian.numpy(), np.asarray(jres.hessian),
                               rtol=1e-3, atol=1e-2)
    assert bool(sres.converged) == bool(jres.converged)
    if opts:
        # only the stall exit can have ended these solves early
        assert bool(jres.converged)
        assert int(jres.iterations) < jp.reg_maximum_iterations


def test_align_no_correspondences_matches_jax(rng):
    """With the stall exit on, a solve without a single correspondence
    ends after one iteration, unconverged, in both packages (an update
    epsilon of 0 is never met, so nothing else can end it early)."""
    pts = _three_planes(rng)
    jp = JRegistrationConfig(registration_method="SMALL_GICP",
                             reg_covariance_mode="radius",
                             reg_covariance_radius=1.0,
                             reg_transformation_epsilon=0.0,
                             reg_stall_epsilon=1e-3)
    tp = config_from_fields(dataclasses.asdict(jp))
    far = pts + np.float32(100.0)
    jres = jreg.align(jp, jreg.make_source(JCloud.from_array(far, 2048), jp),
                      jreg.make_target(JCloud.from_array(pts, 2048), jp),
                      jse3.pose_identity())
    tres = treg.align(
        tp, treg.make_source(PointCloud.from_array(far, 2048, device="cpu"),
                             tp),
        treg.make_target(PointCloud.from_array(pts, 2048, device="cpu"), tp),
        tse3.pose_identity())
    assert int(jres.iterations) == int(tres.iterations) == 1
    assert not bool(jres.converged) and not bool(tres.converged)
    assert int(jres.num_inliers) == int(tres.num_inliers) == 0
    np.testing.assert_allclose(tres.pose.numpy(), np.asarray(jres.pose),
                               atol=1e-6)


def test_registration_voxel_family_raises(rng):
    pts = PointCloud.from_array(_three_planes(rng), 2048, device="cpu")
    from mrg_slam_tpu_torch.config import RegistrationConfig

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        treg.make_target(pts, RegistrationConfig(registration_method="NDT"))
