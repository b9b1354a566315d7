"""Plain PyTorch versions of the port's kernels against the Pallas kernels
(interpret mode) and float64 goldens.

The plain versions are what the port runs on the CPU and what
chip_smoke.py holds the CUDA kernels to on the card; here they meet the
JAX package's Pallas kernels (`_nn_kernel`, `_count_kernel`,
`_moments_kernel`) run in interpret mode, and float64 brute force.

Tolerances and why:
- nn, count: exact against Pallas (same exact-difference f32 arithmetic,
  same tie rule), except that XLA:CPU rounds the interpreted kernel's d2
  within 2 ulp of the plain version's step-by-step rounding (rtol 2^-22);
  indices and counts agree exactly. Against float64, indices agree and d2
  is within rtol 1e-5 / atol 1e-4 (f32 rounding of ~45 m coordinates); counts agree
  on every point none of whose pairs lies within 1e-5 m^2 of r^2, where
  f32 rounding may move a pair across the radius.
- moments: counts exact; mean and cov within 2 n u X and 2 n u X^2 + 2 X
  (mean tol) (u = 2^-24, n = neighbours, X = max |coord|): two float32
  summation orders of the raw sums differ by at most that.
- lanes that take part (masks): on every valid source lane the plain
  versions given the rows' masks equal the Pallas kernels (run row by
  row) as above, and the plain versions that sweep every lane bit for
  bit, whatever the masked lanes hold; on every masked source lane they
  write the fixed values, (inf, 0) for nn and zeros for moments.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from mrg_slam_tpu_torch.ops import knn, nn_kernel, stats_kernel
from mrg_slam_tpu_torch.ops.cloud import PAD_VALUE

U32 = 2.0 ** -24


@pytest.fixture
def interpret_pallas(monkeypatch):
    import mrg_slam_tpu.ops.pallas_nn as pn
    import mrg_slam_tpu.ops.pallas_stats as ps

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pn.pl, "pallas_call", interp)
    monkeypatch.setattr(ps.pl, "pallas_call", interp)
    yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nn_case(rng):
    """±45 m sources and targets: masked tail, duplicated targets (ties)
    and sources sitting exactly on duplicated targets (d2 == 0)."""
    src = rng.uniform(-45, 45, size=(1500, 3)).astype(np.float32)
    tgt = rng.uniform(-45, 45, size=(1100, 3)).astype(np.float32)
    tgt[600:650] = tgt[:50]
    src[:50] = tgt[:50]
    mask = np.ones(1100, bool)
    mask[1000:] = False
    return src, tgt, mask


def _clustered(rng, n=800):
    """Dense clusters at the origin and near (42, -42, 40), with exact
    duplicates and a masked tail."""
    pts = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    pts[n // 2:] += np.float32([42.0, -42.0, 40.0])
    pts[100:130] = pts[:30]
    mask = np.ones(n, bool)
    mask[-40:] = False
    return pts, mask


def test_nn_plain_matches_pallas_and_golden(interpret_pallas, rng):
    from mrg_slam_tpu.ops.pallas_nn import nearest_neighbor_pallas

    src, tgt, mask = _nn_case(rng)
    d2, idx = knn.nearest_neighbor(_t(src), _t(tgt), _t(mask))
    pd2, pidx = nearest_neighbor_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                        jnp.asarray(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(pd2), rtol=4 * U32,
                               atol=0)

    g = ((src[:, None, :].astype(np.float64)
          - tgt[None, :1000, :].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_array_equal(idx.numpy(), g.argmin(1))  # lowest tie
    np.testing.assert_allclose(d2.numpy(), g.min(1), rtol=1e-5, atol=1e-4)
    assert (idx[:50].numpy() == np.arange(50)).all()
    assert (d2[:50] == 0).all()


def test_nn_plain_empty_target(interpret_pallas, rng):
    from mrg_slam_tpu.ops.pallas_nn import nearest_neighbor_pallas

    src = rng.normal(size=(64, 3)).astype(np.float32)
    tgt = np.zeros((64, 3), np.float32)
    d2, idx = knn.nearest_neighbor(_t(src), _t(tgt), torch.zeros(64,
                                                                 dtype=bool))
    pd2, pidx = nearest_neighbor_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                        jnp.zeros(64, bool))
    assert torch.isinf(d2).all() and np.isinf(np.asarray(pd2)).all()
    assert (idx == 0).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))


def test_nn_plain_batched_rows_match_single(rng):
    src = _t(rng.uniform(-45, 45, size=(3, 300, 3)).astype(np.float32))
    tgt = _t(rng.uniform(-45, 45, size=(3, 200, 3)).astype(np.float32))
    d2, idx = nn_kernel.nn_plain(src, tgt, chunk=128)
    for b in range(3):
        d1, i1 = nn_kernel.nn_plain(src[b:b + 1], tgt[b:b + 1])
        assert torch.equal(d2[b], d1[0]) and torch.equal(idx[b], i1[0])


@pytest.mark.parametrize("radius", [0.5, 1.0])
def test_count_plain_matches_pallas_and_golden(interpret_pallas, rng,
                                               radius):
    from mrg_slam_tpu.ops.pallas_stats import radius_count_pallas

    pts, mask = _clustered(rng)
    c = knn.radius_count(_t(pts), _t(mask), radius)
    pc = radius_count_pallas(jnp.asarray(pts), jnp.asarray(mask), radius)
    np.testing.assert_array_equal(c.numpy(), np.asarray(pc))

    p64 = pts[mask].astype(np.float64)
    d = ((p64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
    r2 = radius * radius
    golden = ((d <= r2) & (d > 0)).sum(1)
    clear = ~(np.abs(d - r2) < 1e-5).any(1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(c.numpy()[mask][clear], golden[clear])
    assert (c.numpy()[~mask] == 0).all()
    # duplicates are not neighbours of each other (0 < d2 <= r2)
    dup_golden = ((d[:30] <= r2) & (d[:30] > 0)).sum(1)
    np.testing.assert_array_equal(c.numpy()[:30][clear[:30]],
                                  dup_golden[clear[:30]])


def test_moments_plain_matches_pallas_and_golden(interpret_pallas, rng):
    from mrg_slam_tpu.ops.pallas_stats import radius_moments_pallas

    pts, mask = _clustered(rng, 600)
    radius = 1.0
    padded = np.where(mask[:, None], pts, np.float32(PAD_VALUE))
    mo = stats_kernel.moments_plain(_t(padded)[None], _t(padded)[None],
                                    stats_kernel.radius_sq(radius))[0]
    cnt, mean, cov = (v.numpy() for v in
                      stats_kernel.moments_to_mean_cov(mo))
    pcnt, pmean, pcov = (np.asarray(v) for v in radius_moments_pallas(
        jnp.asarray(pts), jnp.asarray(mask), radius))
    m = mask
    np.testing.assert_array_equal(cnt[m], pcnt[m])
    n = cnt[m].max()
    x = np.abs(pts[m]).max()
    tol_mean = 2 * n * U32 * x
    tol_cov = 2 * n * U32 * x * x + 2 * x * tol_mean
    np.testing.assert_allclose(mean[m], pmean[m], rtol=0, atol=tol_mean)
    np.testing.assert_allclose(cov[m], pcov[m], rtol=0, atol=tol_cov)

    p64 = pts[m].astype(np.float64)
    d = ((p64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
    w = (d <= radius * radius).astype(np.float64)  # self included
    clear = ~(np.abs(d - radius * radius) < 1e-5).any(1)
    np.testing.assert_array_equal(cnt[m][clear], w.sum(1)[clear])
    gmean = (w @ p64) / w.sum(1)[:, None]
    gcov = np.einsum("ct,ta,tb->cab", w, p64, p64) / w.sum(1)[:, None, None] \
        - gmean[:, :, None] * gmean[:, None, :]
    np.testing.assert_allclose(mean[m][clear], gmean[clear], rtol=0,
                               atol=tol_mean)
    np.testing.assert_allclose(cov[m][clear], gcov[clear], rtol=0,
                               atol=tol_cov)


# per-row masks of 3 rows of 700 lanes: (where each row's valid lanes
# end, hole lanes). No row ends at a multiple of a tile of the Pallas
# kernels (1024, 2048, 512) or of the CUDA ones (128, 256, 1024, 2048)
_EXTENT_CASES = {
    "prefix": ((697, 389, 131), ()),
    "holes": ((601, 453, 77), (3, 40, 41, 42, 76, 300, 450)),
    "empty_row": ((0, 650, 333), (5, 6, 100)),
}


def _extent_masks(case, b=3, n=700):
    """(b, n) masks whose row r has its last valid lane at ends[r] - 1 (no
    valid lane for 0) -> (masks, ends)."""
    ends, holes = _EXTENT_CASES[case]
    mask = np.arange(n)[None, :] < np.asarray(ends)[:, None]
    for h in holes:
        mask[:, h] = False
    for r, e in enumerate(ends):
        if e:
            mask[r, e - 1] = True
    return mask, np.asarray(ends, np.int32)


def _clustered_rows(rng, b=3, n=700):
    """Per row: dense clusters at the origin and near (42, -42, 40) with
    exact duplicates, as in _clustered."""
    pts = rng.uniform(-3, 3, size=(b, n, 3)).astype(np.float32)
    pts[:, n // 2:] += np.float32([42.0, -42.0, 40.0])
    pts[:, 100:130] = pts[:, :30]
    return pts


@pytest.mark.parametrize("case", sorted(_EXTENT_CASES))
def test_nn_plain_extents_match_pallas(interpret_pallas, rng, case):
    from mrg_slam_tpu.ops.pallas_nn import nearest_neighbor_pallas

    smask, _ = _extent_masks(case)
    tmask, tend = _extent_masks(case)
    tmask, tend = tmask[::-1].copy(), tend[::-1].copy()  # other rows
    src = rng.uniform(-45, 45, size=smask.shape + (3,)).astype(np.float32)
    tgt = rng.uniform(-45, 45, size=tmask.shape + (3,)).astype(np.float32)
    src[:, :40] = tgt[:, 20:60]  # sources on targets: d2 == 0 and ties
    tgt[:, 300:320] = tgt[:, 20:40]
    d2, idx = knn.nearest_neighbor(_t(src), _t(tgt), _t(tmask), _t(smask))
    d2, idx = d2.numpy(), idx.numpy()
    pad = np.where(tmask[..., None], tgt, np.float32(PAD_VALUE))
    fd2, fidx = nn_kernel.nn_plain(_t(src), _t(pad))  # every lane
    for r in range(src.shape[0]):
        v = smask[r]
        pd2, pidx = (np.asarray(a) for a in nearest_neighbor_pallas(
            jnp.asarray(src[r]), jnp.asarray(tgt[r]), jnp.asarray(tmask[r])))
        np.testing.assert_array_equal(idx[r][v], pidx[v])
        np.testing.assert_allclose(d2[r][v], pd2[v], rtol=4 * U32, atol=0)
        assert np.array_equal(d2[r][v].view(np.int32),
                              fd2[r].numpy()[v].view(np.int32))
        assert np.array_equal(idx[r][v], fidx[r].numpy()[v])
        # masked lanes, those past the last valid one among them: (inf, 0)
        assert np.isinf(d2[r][~v]).all() and (idx[r][~v] == 0).all()
        if tend[r] == 0:  # no target: (inf, 0) everywhere
            assert np.isinf(d2[r]).all() and (idx[r] == 0).all()


def test_nn_without_src_mask_computes_every_lane(interpret_pallas, rng):
    """src_mask=None: every source lane is valid, so every real source
    gets the Pallas result, up to the last lane."""
    from mrg_slam_tpu.ops.pallas_nn import nearest_neighbor_pallas

    src = rng.uniform(-45, 45, size=(700, 3)).astype(np.float32)
    src[300:340] = PAD_VALUE  # pads among real sources
    tgt = rng.uniform(-45, 45, size=(500, 3)).astype(np.float32)
    tmask = np.ones(500, bool)
    tmask[450:] = False
    d2, idx = knn.nearest_neighbor(_t(src), _t(tgt), _t(tmask))
    pd2, pidx = (np.asarray(a) for a in nearest_neighbor_pallas(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(tmask)))
    real = (np.abs(src) < 1e5).all(-1)
    np.testing.assert_array_equal(idx.numpy()[real], pidx[real])
    np.testing.assert_allclose(d2.numpy()[real], pd2[real], rtol=4 * U32,
                               atol=0)
    assert np.isfinite(d2.numpy()[real]).all() and real[-1]


@pytest.mark.parametrize("case", sorted(_EXTENT_CASES))
def test_moments_plain_extents_match_pallas(interpret_pallas, rng, case):
    from mrg_slam_tpu.ops.pallas_stats import radius_moments_pallas

    mask, _ = _extent_masks(case)
    pts = _clustered_rows(rng)
    padded = np.where(mask[..., None], pts, np.float32(PAD_VALUE))
    r2 = stats_kernel.radius_sq(1.0)
    # the masks on the unpadded points, as estimate_covariances_radius
    # calls it, against every lane of the padded points
    mo = stats_kernel.moments_plain(_t(pts), _t(pts), r2, _t(mask),
                                    _t(mask))
    full = stats_kernel.moments_plain(_t(padded), _t(padded), r2)
    cnt, mean, cov = (v.numpy() for v in
                      stats_kernel.moments_to_mean_cov(mo))
    for r in range(pts.shape[0]):
        m = mask[r]
        assert (mo[r].numpy()[~m] == 0).all()
        if not m.any():
            continue
        np.testing.assert_array_equal(mo[r].numpy()[m], full[r].numpy()[m])
        pcnt, pmean, pcov = (np.asarray(v) for v in radius_moments_pallas(
            jnp.asarray(pts[r]), jnp.asarray(m), 1.0))
        np.testing.assert_array_equal(cnt[r][m], pcnt[m])
        n = cnt[r][m].max()
        x = np.abs(pts[r][m]).max()
        tol_mean = 2 * n * U32 * x
        tol_cov = 2 * n * U32 * x * x + 2 * x * tol_mean
        np.testing.assert_allclose(mean[r][m], pmean[m], rtol=0,
                                   atol=tol_mean)
        np.testing.assert_allclose(cov[r][m], pcov[m], rtol=0, atol=tol_cov)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrapper raises rather than running."""
    pts = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError):
        nn_kernel.nn_cuda(pts, pts)
    with pytest.raises(ValueError):
        stats_kernel.count_cuda(pts, pts, 0.25)
    with pytest.raises(ValueError):
        stats_kernel.moments_cuda(pts, pts, 0.25)
    mask = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError):
        nn_kernel.nn_cuda(pts, pts, mask, mask)


def test_mask_ptr_checks_the_mask():
    """A kernel takes a (B, lanes) contiguous bool mask on its clouds'
    device, or None for every lane; anything else raises."""
    from mrg_slam_tpu_torch.ops import native

    cpu = torch.device("cpu")
    assert native.mask_ptr(cpu, 2, 5, None) is None
    mask = torch.ones((2, 5), dtype=torch.bool)
    assert native.mask_ptr(cpu, 2, 5, mask) == mask.data_ptr()
    for bad in (torch.ones((5, 2), dtype=torch.bool),
                torch.ones((2, 5), dtype=torch.uint8),
                torch.ones((5, 2), dtype=torch.bool).t()):
        with pytest.raises(ValueError):
            native.mask_ptr(cpu, 2, 5, bad)
