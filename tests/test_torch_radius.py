"""radius^2 is rounded as the JAX package rounds it.

The JAX package writes the squared radius of its radius tests as
`jnp.float32(radius * radius)` (ops/knn.py, ops/covariance.py,
ops/pallas_stats.py), but every one of those lines runs inside a jitted
function that traces `radius`: the radius arrives as a float32 and the
product is a float32 multiply. For a Python float the same expression
would round the double product once, which gives another float32 for
about half of all radii, among them 0.1, 0.4, 0.7 and 0.8 m. A pair of
points whose float32 d2 lies between the two values is a neighbour under
one rounding and not under the other. Here such a pair goes through the
port's three radius tests (`knn.radius_count`, `knn.nn_within`'s gate, the
covariance neighbour count) and the JAX package's, which must agree
exactly.

Every squared distance in these clouds is exact in float32 (coordinates
with few significant bits, one pair along an axis or in a plane), so the
JAX package's |s|^2 + |t|^2 - 2 s.t form on the CPU and the port's exact
differences give the same d2, and only r^2 can tell the packages apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.ops import covariance as jcov
from mrg_slam_tpu.ops import knn as jknn
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud

from mrg_slam_tpu_torch.ops import covariance as tcov
from mrg_slam_tpu_torch.ops import knn as tknn
from mrg_slam_tpu_torch.ops import stats_kernel
from mrg_slam_tpu_torch.ops.cloud import PointCloud

# the second point of a boundary pair (the first sits at the origin): its
# squared norm is the larger of the two roundings of r^2. For 0.7 the
# larger one is not the square of a float32, so the pair lies in a plane.
_BOUNDARY = {0.1: (np.float32(0.1), 0.0), 0.4: (np.float32(0.4), 0.0),
             0.7: (0.09619140625, 0.693359375),
             0.8: (np.float32(0.8), 0.0)}


def _traced_r2(radius):
    """r^2 as the JAX package's jitted radius tests form it."""
    return np.asarray(jax.jit(lambda r: jnp.float32(r * r))(radius))


def test_radius_sq_rounds_as_the_jax_package():
    radii = np.round(np.arange(1, 3001) * 1e-3, 3)
    want = _traced_r2(radii.astype(np.float32))
    got = np.array([stats_kernel.radius_sq(r) for r in radii], np.float32)
    np.testing.assert_array_equal(got, want)
    # the double product rounded once is another float32 for many radii
    assert (np.float32(radii * radii) != want).sum() > 1000


@pytest.mark.parametrize("radius", sorted(_BOUNDARY))
def test_boundary_pair_matches_jax(radius):
    r2_traced = _traced_r2(radius)
    r2_double = np.float32(radius * radius)
    assert r2_traced != r2_double  # the radii where the roundings differ
    assert stats_kernel.radius_sq(radius) == r2_traced

    bx, by = (np.float32(v) for v in _BOUNDARY[radius])
    d2 = np.float32(np.float32(bx * bx) + np.float32(by * by))
    assert d2 == max(r2_traced, r2_double)
    within = bool(d2 <= r2_traced)

    # A and B are the pair; C sits within the radius of A only, so A's
    # covariance neighbourhood reaches the 3 points it needs exactly when
    # the pair is within the radius
    c = np.float32(radius / 4)
    pts = np.array([[0, 0, 0], [bx, by, 0], [0, 0, c]], np.float32)
    mask = np.ones(3, bool)
    jc = JCloud(points=pts, mask=mask)
    tc = PointCloud(torch.from_numpy(pts), torch.from_numpy(mask))

    counts = tknn.radius_count(tc.points, tc.mask, radius).numpy()
    np.testing.assert_array_equal(
        counts, np.asarray(jknn.radius_count(pts, mask, radius)))
    assert counts[1] == int(within)

    src, smask = pts[:1], mask[:1]
    tgt, tmask = pts[1:2], mask[1:2]
    _, _, valid = tknn.nn_within(torch.from_numpy(src),
                                 torch.from_numpy(smask),
                                 torch.from_numpy(tgt),
                                 torch.from_numpy(tmask), radius)
    _, _, jvalid = jknn.nn_within(src, smask, tgt, tmask, radius)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert bool(valid[0]) == within

    # the port's neighbour count, and through the count >= 3 gate the
    # covariance of A, against the JAX package's
    mo = stats_kernel.moments_plain(tc.points[None], tc.points[None],
                                    stats_kernel.radius_sq(radius))[0]
    assert mo[0, 0] == 2 + int(within)
    tcovs = tcov.estimate_covariances_radius(tc, radius).covs.numpy()
    jcovs = np.asarray(jcov.estimate_covariances_radius(jc, radius).covs)
    assert (tcovs[0] == np.eye(3, dtype=np.float32)).all() != within
    np.testing.assert_allclose(tcovs, jcovs, rtol=0, atol=1e-5)
