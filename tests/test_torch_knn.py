"""The port's top-k kNN and what uses it (kNN covariances, STATISTICAL
outlier removal), deskewing, the dynamic synthetic world, RPE, TUM files
and the engine config, against the JAX package on the same numpy inputs.

Tolerances and why:
- knn: bitwise (indices and d2) against a numpy golden that rounds d2 as
  the port does, ((dx*dx + dy*dy) + dz*dz) in float32, and breaks ties by
  a stable sort, so the lowest index wins; the same against the JAX
  package's CPU `knn` with exact differences (its |s|^2 + |t|^2 - 2 s.t
  expansion rounds d2 otherwise, ROADMAP.md §3 B1), indices equal and d2
  within 1e-6 relative (XLA may contract the sum into fused multiply-adds).
- kNN covariances: within 1e-5 of the JAX package's on points whose
  normal is well posed (the two smallest eigenvalues of the neighbourhood
  apart by 1e-3 or more; the regularized matrix turns with the normal, so
  on a near-degenerate neighbourhood both take it from rounding noise).
- STATISTICAL masks: equal.
- deskew at +-45 m raw coordinates: within 1e-5 m (a few float32 ulps of
  45 m, the two packages' so3_exp rounding); the identity case bitwise.
- synthetic scans and trajectories: bitwise (numpy on both sides).
- RPE, TUM files: equal (the same numpy code).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu import config as jconfig
from mrg_slam_tpu.io import synthetic as jsyn
from mrg_slam_tpu.ops import covariance as jcov
from mrg_slam_tpu.ops import knn as jknn
from mrg_slam_tpu.ops import prefilter as jpre
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.utils import metrics as jmetrics
from mrg_slam_tpu.utils import tum as jtum

from mrg_slam_tpu_torch import config as tconfig
from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.io import synthetic as tsyn
from mrg_slam_tpu_torch.ops import covariance as tcov
from mrg_slam_tpu_torch.ops import knn as tknn
from mrg_slam_tpu_torch.ops import prefilter as tpre
from mrg_slam_tpu_torch.ops import registration as treg
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.utils import metrics as tmetrics
from mrg_slam_tpu_torch.utils import tum as ttum

from test_torch_multirobot import exact_jax_nn  # noqa: F401 (a fixture)


def _t(a):
    return torch.from_numpy(np.array(a))


def _golden_knn(src, tgt, mask, k):
    """numpy: d2 rounded as the port rounds it, ties to the lowest index."""
    d = [src[:, None, a] - tgt[None, :, a] for a in range(3)]
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    d2 = np.where(mask[None, :], d2, np.float32(np.inf))
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, idx, 1), idx


def _grid(n_side=8, spacing=0.5):
    """Integer-lattice points: every point has many equidistant
    neighbours, so the k-th place is tied."""
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
    return (g.reshape(-1, 3) * spacing + 30.0).astype(np.float32)


def _cloud(rng, n=400):
    """Ground, a wall and clutter 5-40 m out, as a voxelized scan."""
    g = np.stack([rng.uniform(5, 40, n // 2), rng.uniform(-15, 15, n // 2),
                  rng.normal(-1.5, 0.02, n // 2)], 1)
    w = np.stack([rng.uniform(5, 40, n // 4), 9 + rng.normal(0, 0.02, n // 4),
                  rng.uniform(-1.5, 2, n // 4)], 1)
    c = rng.uniform([5, -15, -1.5], [40, 15, 4], (n - n // 2 - n // 4, 3))
    return np.concatenate([g, w, c]).astype(np.float32)


@pytest.mark.parametrize("case", ["lattice-ties", "masked", "few-valid"])
def test_knn_matches_numpy_and_jax(rng, case, exact_jax_nn, monkeypatch):
    if case == "lattice-ties":
        tgt = _grid()
        src = tgt[::3] + np.float32(0.0)
        mask = np.ones(len(tgt), bool)
        k = 10
    else:
        tgt = _cloud(rng)
        src = _cloud(rng, 200)
        mask = rng.uniform(size=len(tgt)) < (0.7 if case == "masked"
                                             else 0.02)
        tgt = np.where(mask[:, None], tgt, np.float32(1e6))
        k = 12
    want_d2, want_idx = _golden_knn(src, tgt, mask, k)
    # several chunks, and one: the same result
    for elems in (len(tgt) * 7, tknn._CHUNK_ELEMS):
        monkeypatch.setattr(tknn, "_CHUNK_ELEMS", elems)
        d2, idx = tknn.knn(_t(src), _t(tgt), _t(mask), k)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        np.testing.assert_array_equal(d2.numpy(), want_d2)
    if case == "lattice-ties":
        # ties at the k-th place do occur
        assert (want_d2[:, k - 1] == want_d2[:, k - 2]).any()
    jd2, jidx = jknn.knn(jnp.asarray(src), jnp.asarray(tgt),
                         jnp.asarray(mask), k=k)
    np.testing.assert_array_equal(np.asarray(jidx), want_idx)
    finite = np.isfinite(want_d2)
    np.testing.assert_allclose(np.asarray(jd2)[finite], want_d2[finite],
                               rtol=1e-6, atol=1e-6)
    # the first neighbour is the 1-NN, and leading batch dims pass through
    nd2, nidx = tknn.nearest_neighbor(_t(src), _t(tgt), _t(mask))
    np.testing.assert_array_equal(nidx.numpy(), want_idx[:, 0])
    np.testing.assert_array_equal(nd2.numpy(), want_d2[:, 0])
    bd2, bidx = tknn.knn(_t(np.stack([src, src])), _t(np.stack([tgt, tgt])),
                         _t(np.stack([mask, mask])), k)
    assert bidx.shape == (2, len(src), k)
    np.testing.assert_array_equal(bidx[1].numpy(), want_idx)
    with pytest.raises(ValueError):
        tknn.knn(_t(src), _t(tgt), _t(mask), len(tgt) + 1)


def _jcloud(pts, mask):
    return JCloud(jnp.asarray(np.where(mask[:, None], pts,
                                       np.float32(1e6))), jnp.asarray(mask))


def test_knn_covariances_match_jax(rng, exact_jax_nn):
    pts = _cloud(rng)
    mask = np.ones(len(pts), bool)
    mask[-40:] = False
    jc = _jcloud(pts, mask)
    tc = PointCloud(_t(np.asarray(jc.points)), _t(mask))
    want = np.asarray(jcov.estimate_covariances(jc, k=10).covs)
    got = tcov.estimate_covariances(tc, k=10).covs.numpy()
    # the normal is well posed where the neighbourhood's two smallest
    # eigenvalues stand apart
    _, idx = tknn.knn(tc.points, tc.points, tc.mask, 10)
    nb = pts[idx.numpy()].astype(np.float64)
    cov64 = np.einsum("nka,nkb->nab", nb - nb.mean(1, keepdims=True),
                      nb - nb.mean(1, keepdims=True)) / 10
    ev = np.linalg.eigvalsh(cov64)
    posed = mask & (ev[:, 1] - ev[:, 0] > 1e-3)
    assert posed.sum() > 300
    np.testing.assert_allclose(got[posed], want[posed], rtol=0, atol=1e-5)
    assert (got[~mask] == np.eye(3, dtype=np.float32)).all()
    # make_source routes reg_covariance_mode="knn" with k =
    # reg_correspondence_randomness
    params = tconfig.RegistrationConfig(reg_covariance_mode="knn",
                                        reg_correspondence_randomness=10)
    np.testing.assert_array_equal(treg.make_source(tc, params).covs.numpy(),
                                  got)
    assert treg.covariance_compatible(params, params)
    assert not treg.covariance_compatible(params, dataclasses.replace(
        params, reg_correspondence_randomness=20))


def test_statistical_mask_matches_jax(rng, exact_jax_nn):
    pts = _cloud(rng, 600)
    pts[::50] += rng.uniform(-6, 6, (12, 3)).astype(np.float32)  # outliers
    mask = np.ones(len(pts), bool)
    mask[-30:] = False
    jc = _jcloud(pts, mask)
    tc = PointCloud(_t(np.asarray(jc.points)), _t(mask))
    want = np.asarray(jpre.statistical_outlier_mask(jc, 30, 1.2))
    got = tpre.statistical_outlier_mask(tc, 30, 1.2).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (mask & ~got).sum() < 100
    # leading batch dims: each cloud its own statistics
    two = tpre.statistical_outlier_mask(
        PointCloud(torch.stack([tc.points, tc.points * 2]),
                   torch.stack([tc.mask, tc.mask])), 30, 1.2)
    np.testing.assert_array_equal(two[0].numpy(), want)


def _raw(rng, n=3000):
    return rng.uniform(-45, 45, (n, 3)).astype(np.float32)


def test_deskew_matches_jax(rng):
    pts = _raw(rng)
    mask = np.ones(len(pts), bool)
    mask[-100:] = False
    jc = _jcloud(pts, mask)
    tc = PointCloud(_t(np.asarray(jc.points)), _t(mask))
    frac = np.linspace(0, 1, len(pts)).astype(np.float32)
    w = np.asarray([0.3, -0.2, 1.5], np.float32)
    want = jpre.deskew(jc, jnp.asarray(frac), jnp.asarray(w), 0.1)
    got = tpre.deskew(tc, _t(frac), _t(w), 0.1)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_allclose(got.points.numpy()[mask],
                               np.asarray(want.points)[mask], rtol=0,
                               atol=1e-5)
    assert (got.points.numpy()[~mask] == 1e6).all()
    # the last point turned by the whole sweep's rotation
    assert np.abs(got.points.numpy()[mask][-1] - pts[mask][-1]).max() > 0.05
    ident = tpre.deskew(tc, _t(frac), torch.zeros(3), 0.1)
    np.testing.assert_array_equal(ident.points.numpy(), tc.points.numpy())


def test_synthetic_dynamic_world_bitwise():
    kw = dict(seed=5, extent=20.0, n_ground=3000, n_pillars=5, n_walls=3,
              max_points_per_scan=1500, noise=0.02, n_dynamic=4)
    jw, tw = jsyn.SyntheticWorld.build(**kw), tsyn.SyntheticWorld.build(**kw)
    for f in ("points", "dyn_p0", "dyn_vel", "dyn_size"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f))
    for name, args in (("circle_trajectory", (7,)),
                       ("straight_trajectory", (5, 0.7)),
                       ("figure8_trajectory", (9,))):
        np.testing.assert_array_equal(getattr(tsyn, name)(*args),
                                      getattr(jsyn, name)(*args))
    for i, p in enumerate(tsyn.figure8_trajectory(6, radius=8.0)):
        a, b = tw.scan(p, seed=i, t=0.4 * i), jw.scan(p, seed=i, t=0.4 * i)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # the occluders move: a scan at another time differs
    p = tsyn.circle_trajectory(1, radius=3.0)[0]
    assert not np.array_equal(tw.scan(p, seed=0, t=0.0),
                              tw.scan(p, seed=0, t=3.0))


def test_rpe_tum_and_engine_config_match_jax(rng, tmp_path):
    est = rng.normal(size=(30, 3))
    gt = est + rng.normal(scale=0.05, size=(30, 3))
    assert tmetrics.rpe_rmse(est, gt) == jmetrics.rpe_rmse(est, gt)
    assert tmetrics.rpe_rmse(est, gt, 3) == jmetrics.rpe_rmse(est, gt, 3)
    poses = np.concatenate([est, rng.normal(size=(30, 4))], 1).astype(
        np.float32)
    stamps = np.arange(30) * 0.1
    ttum.save_tum(tmp_path / "t.txt", stamps, poses)
    jtum.save_tum(tmp_path / "j.txt", stamps, poses)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    for (a, b) in zip(ttum.load_tum(tmp_path / "t.txt"),
                      jtum.load_tum(tmp_path / "j.txt")):
        np.testing.assert_array_equal(a, b)

    jc = jconfig.EngineConfig(
        model_namespace="bestla",
        lidar2base=jconfig.StaticTransformConfig(x=0.1, z=1.2, roll=0.02,
                                                 pitch=-0.1, yaw=0.7),
        floor=jconfig.FloorDetectionConfig(sensor_height=1.4),
        odometry=jconfig.ScanMatchingOdometryConfig(
            enable_imu_frontend=True, registration=jconfig.RegistrationConfig(
                reg_covariance_mode="knn")),
        slam=jconfig.SlamConfig(multi_robot_names=("bestla",)))
    tc = config_from_fields(dataclasses.asdict(jc))
    assert type(tc) is tconfig.EngineConfig
    assert type(tc.lidar2base) is tconfig.StaticTransformConfig
    assert type(tc.floor) is tconfig.FloorDetectionConfig
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    np.testing.assert_allclose(tc.lidar2base.pose7(), jc.lidar2base.pose7(),
                               rtol=0, atol=1e-6)
    assert tc.lidar2base.pose7().dtype == np.float32
    assert dataclasses.asdict(tconfig.EngineConfig()) == dataclasses.asdict(
        jconfig.EngineConfig())
