"""The count kernel's contract and its cell-binned search, on the CPU.

The CUDA kernel (csrc/radius_stats.cu:count_kernel) runs only on a card;
here its plain version meets the Pallas kernel, and a numpy model of the
kernel's search (its cell rule, bucket hash and 27-cell stencil, with the
constants read from the kernel's source) meets the plain version.

Tolerances: none. Counts decide the RADIUS mask, so every count must be
exact: the plain version equals the Pallas kernel (interpret mode) on
every lane, and the model of the binned search equals the plain version,
on clustered points, exact duplicates, masked lanes that hold real-looking
points, rows in one cell, pairs at the radius across cell faces, small
bucket tables whose stencil runs wrap, and far or non-finite coordinates.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mrg_slam_tpu_torch.ops import stats_kernel as sk

CSRC = Path(__file__).resolve().parent.parent / "mrg_slam_tpu_torch" / "csrc"


@pytest.fixture
def interpret_pallas(monkeypatch):
    import mrg_slam_tpu.ops.pallas_stats as ps

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", interp)
    yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clustered(rng, n=900):
    """Two dense clusters (origin, near (42, -42, 40)), exact duplicates,
    and masked lanes spread over the row that hold points like the valid
    ones (a masked lane must take no part whatever it holds)."""
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    pts[n // 2:] += np.float32([42.0, -42.0, 40.0])
    pts[100:130] = pts[:30]
    mask = rng.uniform(size=n) > 0.2
    mask[-50:] = False
    return pts, mask


@pytest.mark.parametrize("radius", [0.5, 0.8])
def test_count_plain_mask_matches_pallas(interpret_pallas, rng, radius):
    from mrg_slam_tpu.ops.pallas_stats import radius_count_pallas

    pts, mask = _clustered(rng)
    c = sk.count_plain(_t(pts)[None], _t(mask)[None],
                       sk.radius_sq(radius))[0].numpy()
    pc = np.asarray(radius_count_pallas(jnp.asarray(pts), jnp.asarray(mask),
                                        radius))
    np.testing.assert_array_equal(c, pc)
    assert (c[~mask] == 0).all() and c[mask].max() > 5
    # None marks every lane: the masked lanes then count as points too
    every = sk.count_plain(_t(pts)[None], None, sk.radius_sq(radius))[0]
    assert (every.numpy() >= c).all() and (every.numpy() > c).any()


# --- the cell rule -------------------------------------------------------


def _sqdist32(a, b):
    """float32 d2 rounded as mrg::sqdist: ((dx*dx + dy*dy) + dz*dz)."""
    with np.errstate(over="ignore", invalid="ignore"):  # inf, NaN lanes
        d = (a - b).astype(np.float32)
        sq = d * d
        return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _cell_index(points, inv_c):
    """The kernel's cell rule: floor(v * inv_c), the float64 product of
    each float32 coordinate (before its int32 conversion)."""
    return torch.floor(points.to(torch.float64) * inv_c)


def _offsets_at(t, step, rng, n_try=100_000):
    """(dx, dy, dz) float32 multiples of `step` whose float32 d2 lies in
    (t - 4 r step, t], r = sqrt(t): the farthest pairs at that spacing
    that are still within the radius, d2 == t among them where the
    spacing allows it; in every direction of the first octant,
    axis-aligned ones included."""
    r = np.sqrt(np.float64(t))
    u = np.abs(rng.normal(size=(n_try, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    u[:64] = (1.0, 0.0, 0.0)
    dx, dy = (np.round(r * u[:, k] / step) * step for k in (0, 1))
    want = np.sqrt(np.maximum(np.float64(t) - dx * dx - dy * dy, 0.0))
    out = []
    for k in (-2, -1, 0, 1, 2):
        dz = (np.round(want / step) + k) * step
        off = np.stack([dx, dy, dz], -1).astype(np.float32)
        d2 = _sqdist32(off, np.zeros_like(off))
        out.append(off[(d2 <= t) & (d2 > t - 4 * r * step)])
    return np.unique(np.concatenate(out), axis=0)


def _axis_reach(t, step):
    """The longest multiple of `step` whose float32 square is <= t."""
    k = np.floor(np.sqrt(np.float64(t)) / step) + 1
    while np.float32(k * step) * np.float32(k * step) > t:
        k -= 1
    return np.float32(k * step)


@pytest.mark.parametrize("radius", [0.5, 0.3, 0.1])
@pytest.mark.parametrize("scale,step", [(45.0, 2.0 ** -18),
                                        (1000.0, 2.0 ** -14)],
                         ids=["45m", "1km"])
def test_count_cell_rule_holds_at_the_radius(rng, radius, scale, step):
    """Pairs at the radius, straddling cell faces at up to +-scale, for
    r^2 and for one ulp of r^2 below and above it: at each threshold t,
    with the cells of `count_cell(t)`, the farthest pairs with d2 <= t
    lie at most one cell apart on every axis. At 45 m the pairs include
    many with d2 == t exactly; at 1 km the spacing of float32 coordinates
    (2^-14 m) makes d2 a multiple of 2^-28, which t need not be. A
    quarter of the pairs lie along one axis as long as d2 <= t allows,
    from the last float32 step before a face: a cell side even 2^-22
    below r fails here."""
    r2 = np.float32(sk.radius_sq(radius))
    for t in (np.nextafter(r2, np.float32(0)), r2,
              np.nextafter(r2, np.float32(1))):
        off = _offsets_at(t, step, rng)
        assert len(off) > 20
        c, inv_c = sk.count_cell(float(t))
        m = 4096
        pick = off[rng.integers(0, len(off), m)]
        exact = off[_sqdist32(off, np.zeros_like(off)) == t]
        if step == 2.0 ** -18:  # half the pairs at d2 == t exactly
            assert len(exact) > 20
            pick[::2] = exact[rng.integers(0, len(exact), m // 2)]
        pick = (pick * rng.choice([-1, 1], (m, 3))).astype(np.float32)
        # a sits just before a face on every axis, by a random share of
        # the offset, so b = a + offset crosses it wherever it moves
        face = rng.integers(-int(scale / c), int(scale / c), (m, 3)) * c
        share = rng.uniform(0.0, 1.0, (m, 3)) * np.abs(pick)
        # a quarter of the pairs reach as far as a pair can: the longest
        # offset along one axis, from the last float32 step before a face
        along = rng.integers(0, 3, m // 4)
        pick[1::4] = 0.0
        pick[1::4][np.arange(m // 4), along] = _axis_reach(t, step) * \
            rng.choice([-1, 1], m // 4)
        share[1::4] = 0.0
        a = np.where(pick >= 0, face - share, face + share)
        a = (np.floor(a / step) * step).astype(np.float32)
        b = (a + pick).astype(np.float32)
        assert (b - a == pick).all()  # exact: the d2 is the offset's
        d2 = _sqdist32(a, b)
        assert (d2 <= t).all()
        assert (d2[::2] == t).all() if step == 2.0 ** -18 else True
        assert (d2[1::4] > np.float32(t) * np.float32(0.999)).all()
        ca = _cell_index(_t(a), inv_c).numpy()
        cb = _cell_index(_t(b), inv_c).numpy()
        assert (np.abs(ca - cb) <= 1).all()
        assert (ca != cb).any(-1).mean() > 0.5  # most cross a face


def test_count_cell_rule_holds_far_out():
    """Pairs along an axis a few float32 steps apart at PAD_VALUE (1e6),
    where such steps are 1/16 m, at 2^24 c and at 3e38: those within the
    radius lie at most one cell apart; beyond ~2^24 c distinct float32
    coordinates are outside the radius, so a pair within it shares its
    coordinate and its cell."""
    r2 = np.float32(sk.radius_sq(0.5))
    c, inv_c = sk.count_cell(float(r2))
    assert c >= np.sqrt(r2) * (1 + 2.0 ** -10) * (1 - 2.0 ** -52)
    for v in (1.0e6, 2.0 ** 24 * c, 3.0e38):
        x = np.float32(v)
        line = [x]
        for _ in range(40):
            line.append(np.nextafter(line[-1], np.float32(np.inf)))
        pts = np.zeros((len(line), 3), np.float32)
        pts[:, 0] = line
        d2 = _sqdist32(pts[:, None], pts[None])
        near = d2 <= r2
        cells = _cell_index(_t(pts), inv_c).numpy()[:, 0]
        assert (np.abs(cells[:, None] - cells[None])[near] <= 1).all()
        if v >= 2.0 ** 24 * c:
            assert (near == np.eye(len(line), dtype=bool)).all()
        else:
            assert near.sum() > 10 * len(line)


# --- a numpy model of the kernel's binned search ---------------------------


def _kernel_constants():
    src = (CSRC / "radius_stats.cu").read_text()

    def grab(name, pattern):
        return int(re.search(rf"{name} = ({pattern})", src).group(1), 0)

    return (grab("kP2", "0x[0-9A-Fa-f]+"), grab("kP3", "0x[0-9A-Fa-f]+"),
            grab("kMinHashBits", "[0-9]+"))


def _blocks_answer_each_point_once(bucket, mask, h, rng, split=4):
    """The kernel's split of a row over `split` blocks: each block bins
    the row with its own order of points within a bucket (the atomics')
    and answers the points of its share of the buckets. -> True when every
    valid lane is answered exactly once."""
    answered = np.zeros(len(bucket), np.int64)
    valid = np.flatnonzero(mask)
    end = np.cumsum(np.bincount(bucket[valid], minlength=h))
    end = np.concatenate([[0], end])  # end[k] = start of bucket k
    for part in range(split):
        order = valid[np.lexsort((rng.random(len(valid)), bucket[valid]))]
        lo, hi = end[h * part // split], end[h * (part + 1) // split]
        answered[order[lo:hi]] += 1
    return (answered[valid] == 1).all() and (answered[~mask] == 0).all()


def _binned_count(points, mask, r2, bits, rng):
    """The kernel's search in numpy: each valid point goes to bucket
    hash(cell) mod H; a source tests, with the exact d2, every valid point
    in the buckets of the 27 cells around its own, once per time a bucket
    comes up. -> (counts, the most times any point was tested by one
    source); asserts that the blocks of a row answer every point once."""
    p2, p3, _ = _kernel_constants()
    _, inv_c = sk.count_cell(r2)
    t = _cell_index(_t(points), inv_c).numpy()
    t = np.where(np.isnan(t), 0.0, np.clip(t, -2.0 ** 31, 2.0 ** 31 - 1))
    cell = t.astype(np.int64) % 2 ** 32  # int32 bits, wrapping as unsigned
    full = (cell[:, 0] + cell[:, 1] * p2 + cell[:, 2] * p3) % 2 ** 32
    h = 1 << bits
    bucket = full % h
    n = len(points)
    visits = np.zeros((n, h), np.int64)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                off = (dx + dy * p2 + dz * p3) % 2 ** 32
                np.add.at(visits, (np.arange(n), (full + off) % h), 1)
    tested = visits[:, bucket] * mask[None, :]  # (source, candidate)
    d2 = _sqdist32(points[:, None, :], points[None, :, :])
    ok = (d2 <= np.float32(r2)) & (d2 > 0)
    counts = np.where(mask, (tested * ok).sum(1), 0)
    assert _blocks_answer_each_point_once(bucket, mask, h, rng)
    return counts, int(tested.max(initial=0))


def test_count_kernel_stencil_buckets_differ():
    """The static_assert of the kernel, in numpy: the 27 cells around a
    point go to 27 buckets for every H >= 2^kMinHashBits."""
    p2, p3, min_bits = _kernel_constants()
    for bits in range(min_bits, 21):
        offs = {(dx + dy * p2 + dz * p3) % 2 ** 32 % (1 << bits)
                for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1)}
        assert len(offs) == 27


def _one_cell(rng, n=600):
    c, _ = sk.count_cell(sk.radius_sq(0.5))
    pts = (rng.uniform(0.01, 0.3, (n, 3)) + 7 * c).astype(np.float32)
    return pts, np.ones(n, bool)


def _boundary_row(rng, n=1200):
    """Pairs at d2 == r^2 (r = 0.5) straddling cell faces near +-45 m."""
    r2 = np.float32(sk.radius_sq(0.5))
    c, _ = sk.count_cell(float(r2))
    off = _offsets_at(r2, 2.0 ** -18, rng)
    k = n // 2
    pick = off[rng.integers(0, len(off), k)] * rng.choice([-1, 1], (k, 3))
    face = rng.integers(-89, 89, (k, 3)) * c
    a = np.floor((face - 0.5 * pick) / 2.0 ** -18) * 2.0 ** -18
    a = a.astype(np.float32)
    pts = np.concatenate([a, (a + pick).astype(np.float32)])
    return pts, np.ones(n, bool)


def _far_and_odd(rng, n=500):
    """Real points, lanes at PAD_VALUE (some a float32 step apart), and
    lanes holding inf and NaN."""
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    pts[:100] = np.float32(1.0e6)
    pts[50:100, 0] = np.nextafter(np.float32(1.0e6), np.float32(2e6))
    pts[100:110, 1] = np.inf
    pts[110:120, 2] = np.nan
    mask = np.ones(n, bool)
    mask[200:260] = False
    return pts, mask


@pytest.mark.parametrize("case", ["clustered", "one_cell", "boundary",
                                  "far_and_odd"])
@pytest.mark.parametrize("few_buckets", [False, True],
                         ids=["kernel_buckets", "64_buckets"])
def test_binned_search_matches_plain(rng, case, few_buckets):
    """The model of the kernel's search equals the plain sweep exactly,
    and tests no point twice for one source; with 64 buckets most
    stencil runs collide and many wrap past the last bucket."""
    pts, mask = {"clustered": _clustered, "one_cell": _one_cell,
                 "boundary": _boundary_row,
                 "far_and_odd": _far_and_odd}[case](rng)
    r2 = sk.radius_sq(0.5)
    bits = 6 if few_buckets else sk.count_hash_bits(len(pts))
    got, most = _binned_count(pts, mask, r2, bits, rng)
    want = sk.count_plain(_t(pts)[None], _t(mask)[None], r2)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert most == 1
    assert want.max() > 0


def test_count_hash_bits_and_row_limit():
    """H >= 2N, at least 64, within the kernel's own bounds on its hash
    bits (read from its source); a row beyond 2^23 lanes raises before
    any launch. Rows too long for a block's shared memory are no longer
    refused: they bin in global memory (tests/test_torch_cuda.py)."""
    src = (CSRC / "radius_stats.cu").read_text()
    for name, value in (("kMinHashBits", sk.COUNT_MIN_HASH_BITS),
                        ("kMaxHashBits", sk.COUNT_MAX_HASH_BITS)):
        assert int(re.search(rf"{name} = ([0-9]+)", src).group(1)) == value
    assert sk.count_hash_bits(1) == 6
    assert sk.count_hash_bits(1000) == 11
    assert sk.count_hash_bits(8192) == 14
    assert sk.count_hash_bits(8193) == 15
    assert sk.count_hash_bits(32768) == 16
    assert sk.count_hash_bits(2 ** 23) == 24
    with pytest.raises(ValueError, match="longer than"):
        sk.count_hash_bits(2 ** 23 + 1)
