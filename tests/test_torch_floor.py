"""The port's plane RANSAC, normal estimation, floor detection, ground
fill and cloud merge (ops/ransac.py, models/floor_detection.py,
ops/ground_fill.py, ops/cloud.merge) against the JAX package's, on the
same numpy clouds and the same RANSAC triplets: the JAX package draws
them with jax.random inside its jitted fit, and `JaxTriplets` replays
that key stream for the port (the port's own draws come from a
torch.Generator). The JAX package's nearest neighbours run with exact
differences (ROADMAP.md §3 B1), as the port's do.

Tolerances and why:
- ransac_plane: the normal within 1e-5 and d within 1e-4 m (one float32
  least-squares refinement in two libraries at ~20 m coordinates); the
  inlier masks equal except on points within 1e-5 m of the threshold.
- estimate_normals: within 1e-4 up to sign on points whose neighbourhood
  has a well-posed normal (the two smallest scatter eigenvalues apart by
  1e-3 of the largest; closer, the normal turns with rounding noise).
- FloorDetection.detect: the same accept or reject, coefficients within
  1e-4 (the fit above, then a float32 rotation for the tilt).
- ground fill and merge: points within 1e-5 m (the same numpy rings, a
  float32 rotation or fit apart), masks equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.config import FloorDetectionConfig as JFloorConfig
from mrg_slam_tpu.models.floor_detection import FloorDetection as JFloor
from mrg_slam_tpu.ops import cloud as jcloud
from mrg_slam_tpu.ops import ground_fill as jfill
from mrg_slam_tpu.ops import ransac as jransac

from mrg_slam_tpu_torch.config import FloorDetectionConfig
from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.models.floor_detection import FloorDetection
from mrg_slam_tpu_torch.ops import cloud as tcloud
from mrg_slam_tpu_torch.ops import ground_fill as tfill
from mrg_slam_tpu_torch.ops import ransac as transac

from test_torch_multirobot import exact_jax_nn, one_thread  # noqa: F401

H = 256



class JaxTriplets:
    """A port floor sampler that replays the JAX package's key stream: a
    FloorDetection(seed) splits its key once a call and draws randint
    (H, 3) in [0, max(n_valid, 1)) (ransac.py:43-47)."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, mask: torch.Tensor, num: int) -> torch.Tensor:
        self.key, sub = jax.random.split(self.key)
        return triplets_of(sub, mask, num)


def triplets_of(key, mask: torch.Tensor, num: int = H) -> torch.Tensor:
    n = max(int(mask.sum()), 1)
    return torch.from_numpy(np.array(jax.random.randint(
        key, (num, 3), 0, n))).long().to(mask.device)


def _scene(rng, n_ground=1200, n_wall=300, n_noise=100, z0=-1.5, cap=4096):
    """Ground at z = z0 out to ~25 m, a wall and clutter: (points, mask)."""
    g = np.stack([rng.uniform(-25, 25, n_ground), rng.uniform(-25, 25,
                                                              n_ground),
                  z0 + 0.02 * rng.normal(size=n_ground)], 1)
    w = np.stack([rng.uniform(-20, 20, n_wall), np.full(n_wall, 12.0),
                  rng.uniform(z0, z0 + 3, n_wall)], 1)
    c = rng.uniform([-20, -20, z0], [20, 20, z0 + 2.5], (n_noise, 3))
    pts = np.concatenate([g, w, c]).astype(np.float32)
    out = np.full((cap, 3), 1e6, np.float32)
    out[:len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[:len(pts)] = True
    return out, mask


def _clouds(pts, mask):
    return (jcloud.PointCloud(jnp.asarray(pts), jnp.asarray(mask)),
            tcloud.PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)))


def test_ransac_plane_on_the_jax_triplets():
    rng = np.random.default_rng(0)
    pts, mask = _scene(rng)
    jc, tc = _clouds(pts, mask)
    key = jax.random.PRNGKey(3)
    want = jransac.ransac_plane(jc, key, 0.1)
    got = transac.ransac_plane(tc, triplets_of(key, tc.mask), 0.1)
    wc = np.asarray(want.coeffs)
    np.testing.assert_allclose(got.coeffs[:3].numpy(), wc[:3], atol=1e-5)
    np.testing.assert_allclose(float(got.coeffs[3]), wc[3], atol=1e-4)
    assert bool(got.valid) == bool(want.valid)
    # inliers equal but within 1e-5 m of the threshold
    dist = np.abs(pts @ wc[:3] + wc[3])
    edge = np.abs(dist - 0.1) < 1e-5
    diff = got.inlier_mask.numpy() != np.asarray(want.inlier_mask)
    assert not (diff & ~edge).any()
    assert abs(int(got.num_inliers) - int(want.num_inliers)) <= edge.sum()
    assert int(got.num_inliers) > 1100


def test_sample_triplets_draw_valid_ranks():
    mask = torch.zeros(1000, dtype=torch.bool)
    mask[::3] = True
    gen = torch.Generator()
    gen.manual_seed(0)
    t = transac.sample_triplets(mask, H, gen)
    assert t.shape == (H, 3) and t.dtype == torch.int64
    assert int(t.min()) >= 0 and int(t.max()) < int(mask.sum())
    assert len(torch.unique(t)) > 200  # spread over the valid points
    gen.manual_seed(0)
    assert torch.equal(t, transac.sample_triplets(mask, H, gen))
    none = transac.sample_triplets(torch.zeros(8, dtype=torch.bool), 4, gen)
    assert (none == 0).all()


def test_estimate_normals_with_exact_neighbours(exact_jax_nn):
    rng = np.random.default_rng(1)
    pts, mask = _scene(rng, cap=2048)
    jc, tc = _clouds(pts, mask)
    want = np.asarray(jransac.estimate_normals(jc, k=10))
    got = transac.estimate_normals(tc, k=10).numpy()
    # well-posed normals only: the scatter's two smallest eigenvalues
    # apart by 1e-3 of its largest
    from mrg_slam_tpu_torch.ops import knn
    _, idx = knn.knn(tc.points, tc.points, tc.mask, 10)
    nb = pts[idx.numpy()].astype(np.float64)
    nb -= nb.mean(1, keepdims=True)
    ev = np.linalg.eigvalsh(np.einsum("nka,nkb->nab", nb, nb))
    ok = mask & (ev[:, 1] - ev[:, 0] > 1e-3 * ev[:, 2])
    assert ok.sum() > 0.9 * mask.sum()
    dots = np.abs(np.sum(got[ok] * want[ok], axis=1))
    assert np.abs(got[ok] - want[ok]).max() < 1e-4 or \
        (1.0 - dots).max() < 1e-4
    np.testing.assert_allclose(np.abs(got[ok]), np.abs(want[ok]), atol=1e-4)


@pytest.mark.parametrize("case", ["level", "tilted", "rejected"])
def test_floor_detection_matches_jax(exact_jax_nn, case):
    """The level case filters normals, the tilted one (a sensor pitched
    by 8 degrees) too; the rejected one, a 45-degree slope without
    normal filtering, fails the verticality check."""
    rng = np.random.default_rng(2)
    fields = dict(enable_floor_detection=True, sensor_height=1.5,
                  height_clip_range=1.0, floor_pts_thresh=150)
    pts, mask = _scene(rng, cap=2048)
    if case == "tilted":
        fields["tilt_deg"] = 8.0
        t = np.radians(8.0)
        R = np.asarray([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                        [-np.sin(t), 0, np.cos(t)]], np.float32)
        pts[mask] = pts[mask] @ R  # un-rotating by R restores the scene
    if case == "rejected":
        fields.update(enable_normal_filtering=False, height_clip_range=3.0)
        pts[mask, 2] = -1.5 + 0.6 * pts[mask, 0]
        pts[mask] = pts[mask] / 3.0
    jcfg = JFloorConfig(**fields)
    jc, tc = _clouds(pts, mask)
    jdet, tdet = JFloor(jcfg, seed=4), FloorDetection(
        config_from_fields(dataclasses.asdict(jcfg)),
        sampler=JaxTriplets(4))
    for stamp in (0.0, 0.1):  # two calls: the key stream moves on
        want = jdet.detect(jc, stamp)
        got = tdet.detect(tc, stamp)
        assert (got is None) == (want is None) == (case == "rejected")
        if want is not None:
            assert got.stamp == want.stamp
            np.testing.assert_allclose(got.coeffs, want.coeffs, atol=1e-4)
            assert got.coeffs[2] > 0.99 and abs(got.coeffs[3] - 1.5) < 0.05


def test_floor_detection_own_sampler_runs():
    """The port's default sampler: a generator on the cloud's device,
    seeded, the same fit on a rerun."""
    rng = np.random.default_rng(5)
    pts, mask = _scene(rng, cap=2048)
    _, tc = _clouds(pts, mask)
    cfg = FloorDetectionConfig(enable_floor_detection=True,
                               sensor_height=1.5, floor_pts_thresh=150)
    a = FloorDetection(cfg, seed=7).detect(tc, 1.0)
    b = FloorDetection(cfg, seed=7).detect(tc, 1.0)
    assert a is not None and np.array_equal(a.coeffs, b.coeffs)
    assert a.coeffs[2] > 0.99 and abs(a.coeffs[3] - 1.5) < 0.05


def test_ground_fill_and_merge_match_jax():
    rng = np.random.default_rng(6)
    pts, mask = _scene(rng, n_ground=600, n_wall=100, n_noise=20,
                       z0=-0.3, cap=1024)
    jc, tc = _clouds(pts, mask)
    # simple: the base pose's own xy-plane
    base = np.asarray([1.0, -2.0, 0.5, 0.9659258, 0.0, 0.0, 0.2588190],
                      np.float32)
    want = jfill.fill_ground_plane_simple(jc, base, 3.0, 0.5)
    got = tfill.fill_ground_plane_simple(tc, base, 3.0, 0.5)
    assert got.capacity == want.capacity
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               atol=1e-5)
    # ransac: the JAX package's key PRNGKey(seed) drives its fit directly
    want = jfill.fill_ground_plane_ransac(jc, 3.0, 0.5, seed=0)
    got = tfill.fill_ground_plane_ransac(
        tc, 3.0, 0.5, triplets=triplets_of(jax.random.PRNGKey(0), tc.mask))
    assert got.capacity == want.capacity > tc.capacity
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               atol=1e-4)
    own = tfill.fill_ground_plane_ransac(tc, 3.0, 0.5, seed=0)
    assert own.capacity == got.capacity
    # merge: concatenate, compact valid-first, cut to the capacity
    b_pts, b_mask = _scene(np.random.default_rng(7), 50, 10, 5, cap=128)
    jb, tb = _clouds(b_pts, b_mask)
    for cap in (1024 + 128, 700):
        want = jcloud.merge(jc, jb, cap)
        got = tcloud.merge(tc, tb, cap)
        np.testing.assert_array_equal(got.mask.numpy(),
                                      np.asarray(want.mask))
        np.testing.assert_array_equal(got.points.numpy(),
                                      np.asarray(want.points))
