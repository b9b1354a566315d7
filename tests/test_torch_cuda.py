"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA card (marker `cuda`); without one every test skips. On a
machine with a card and without JAX (tests/conftest.py imports it):
`python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""`.
chip_smoke.py makes the same checks at the main path's full shapes.

Tolerances: nn indices and d2 bitwise (both round d2 step by step with no
FMA), counts exact (on voxel-grid rows of the front end's shape and of
the default capacity, one-cell rows, pairs at the radius across cell
faces, duplicates, masked and all-masked rows), moments within the
float32 summation bound of two orders (see chip_smoke.check_moments). With masks (B rows whose valid
lanes end at different lanes, holes, a row without a valid lane; masked
lanes padded or not), nn stays bitwise on every lane and moments hold on
the valid lanes, with the fixed values on the masked lanes.
"""

import numpy as np
import pytest
import torch

from mrg_slam_tpu_torch.ops import knn, nn_kernel, stats_kernel
from mrg_slam_tpu_torch.ops.cloud import pad_invalid

pytestmark = pytest.mark.cuda
U32 = 2.0 ** -24


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cloud(rng, dev, b, n):
    pts = rng.uniform(-45, 45, size=(b, n, 3)).astype(np.float32)
    pts[:, n // 2:] = pts[:, n // 2:] * 0.02 + 30.0  # a dense cluster
    pts[:, 10:20] = pts[:, :10]  # duplicates
    mask = np.ones((b, n), bool)
    mask[:, -n // 8:] = False
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))


@pytest.mark.parametrize("b,n,m", [(1, 1000, 3000), (3, 513, 257),
                                   (1, 8192, 8192)])
def test_nn_kernel_matches_plain(rng, dev, b, n, m):
    src, _ = _cloud(rng, dev, b, n)
    tgt, tmask = _cloud(rng, dev, b, m)
    tgt = pad_invalid(tgt, tmask).contiguous()
    d_k, i_k = nn_kernel.nn_cuda(src, tgt)
    d_p, i_p = nn_kernel.nn_plain(src, tgt)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))


def test_nn_kernel_empty_target(rng, dev):
    src, _ = _cloud(rng, dev, 1, 300)
    d2, idx = knn.nearest_neighbor(src, torch.zeros_like(src),
                                   torch.zeros(src.shape[:2], dtype=bool,
                                               device=dev))
    assert torch.isinf(d2).all() and (idx == 0).all()


def _extent_cloud(rng, dev, ends, n, holes=(), padded=True):
    """B rows of n lanes whose valid lanes end at `ends` (none for 0),
    with hole lanes; the masked lanes sit at PAD_VALUE or, unpadded, hold
    points like the valid ones. -> (points, mask)."""
    pts, _ = _cloud(rng, dev, len(ends), n)
    lanes = torch.arange(n, device=dev)
    mask = lanes[None, :] < torch.tensor(ends, device=dev)[:, None]
    for h in holes:
        mask[:, h] = False
    for r, e in enumerate(ends):
        if e:
            mask[r, e - 1] = True
    if padded:
        pts = pad_invalid(pts, mask).contiguous()
    return pts, mask


# (where the source rows' valid lanes end, the same for the targets,
# lanes, hole lanes)
_EXTENTS = [((997, 3, 0), (1, 640, 999), 1000, ()),
            ((4057,), (3783,), 8192, ()),
            ((700, 129, 257), (300, 513, 1), 800, (5, 128, 129, 255))]


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("sext,text,n,holes", _EXTENTS)
def test_nn_kernel_extents_match_plain(rng, dev, sext, text, n, holes,
                                       padded):
    src, smask = _extent_cloud(rng, dev, sext, n, holes, padded)
    tgt, tmask = _extent_cloud(rng, dev, text, n, holes, padded)
    d_k, i_k = nn_kernel.nn_cuda(src, tgt, smask, tmask)
    d_p, i_p = nn_kernel.nn_plain(src, tgt, smask, tmask)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.isinf(d_k[~smask]).all() and (i_k[~smask] == 0).all()


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("sext,text,n,holes", _EXTENTS)
def test_moments_kernel_extents_match_plain(rng, dev, sext, text, n, holes,
                                            padded):
    p, mask = _extent_cloud(rng, dev, sext, n, holes, padded)
    r2 = stats_kernel.radius_sq(0.6)
    m_k = stats_kernel.moments_cuda(p, p, r2, mask, mask)
    m_p = stats_kernel.moments_plain(p, p, r2, mask, mask)
    torch.cuda.synchronize()
    assert (m_k[~mask] == 0).all()
    c_k, mn_k, v_k = stats_kernel.moments_to_mean_cov(m_k)
    c_p, mn_p, v_p = stats_kernel.moments_to_mean_cov(m_p)
    assert torch.equal(c_k[mask], c_p[mask])
    n_max = float(c_k[mask].max())
    x = float(p[mask].abs().max())
    tol_mean = 2 * n_max * U32 * x
    assert float((mn_k - mn_p)[mask].abs().max()) <= tol_mean
    assert float((v_k - v_p)[mask].abs().max()) <= (
        2 * n_max * U32 * x * x + 2 * x * tol_mean)


@pytest.mark.parametrize("b,n", [(1, 1000), (4, 2048)])
def test_stats_kernels_match_plain(rng, dev, b, n):
    pts, mask = _cloud(rng, dev, b, n)
    p = pad_invalid(pts, mask).contiguous()
    r2 = stats_kernel.radius_sq(0.6)
    for cloud, m in ((p, None), (p, mask), (pts, mask)):
        assert torch.equal(stats_kernel.count_cuda(cloud, m, r2),
                           stats_kernel.count_plain(cloud, m, r2))
    c_k, m_k, v_k = stats_kernel.moments_to_mean_cov(
        stats_kernel.moments_cuda(p, p, r2))
    c_p, m_p, v_p = stats_kernel.moments_to_mean_cov(
        stats_kernel.moments_plain(p, p, r2))
    assert torch.equal(c_k[mask], c_p[mask])
    n_max = float(c_k[mask].max())
    x = float(pts[mask].abs().max())
    tol_mean = 2 * n_max * U32 * x
    assert float((m_k - m_p)[mask].abs().max()) <= tol_mean
    assert float((v_k - v_p)[mask].abs().max()) <= (
        2 * n_max * U32 * x * x + 2 * x * tol_mean)


def _voxel_rows(rng, b=32, n=8192):
    """The front end's count input in shape: rows of n voxel means (a
    0.3 m grid on a ground plane and on walls, jittered), every lane
    valid."""
    g = np.stack(np.meshgrid(np.arange(-100, 100), np.arange(-100, 100),
                             indexing="ij"), -1).reshape(-1, 2) * 0.3
    rows = []
    for _ in range(b):
        ground = g[rng.choice(len(g), n // 2, replace=False)]
        ground = np.concatenate([ground, np.full((n // 2, 1), -1.7)], 1)
        wall = g[rng.choice(len(g), n - n // 2, replace=False)] / 3
        wall = np.stack([np.full(len(wall), 12.0), wall[:, 0], wall[:, 1]],
                        1)
        rows.append(np.concatenate([ground, wall]))
    pts = np.stack(rows) + rng.normal(0, 0.02, (b, n, 3))
    return pts.astype(np.float32), np.ones((b, n), bool)


def _one_cell_rows(rng, b=2, n=3000):
    c, _ = stats_kernel.count_cell(stats_kernel.radius_sq(0.5))
    pts = rng.uniform(0.01, 0.3, (b, n, 3)) + 7 * c
    return pts.astype(np.float32), np.ones((b, n), bool)


def _boundary_rows(rng, b=4, n=4096):
    """Pairs about r = 0.5 m apart (within a few float32 steps of r^2 on
    either side), each crossing a cell face, at up to +-45 m."""
    c, _ = stats_kernel.count_cell(stats_kernel.radius_sq(0.5))
    k = n // 2
    v = rng.normal(size=(b, k, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    a = rng.integers(-89, 89, (b, k, 3)) * c - 0.25 * v
    s = 0.5 * (1 + rng.integers(-4, 5, (b, k, 1)) * 2.0 ** -22)
    pts = np.concatenate([a, a + s * v], 1)
    return pts.astype(np.float32), np.ones((b, n), bool)


def _uniform_rows(rng, b=2, n=8192):
    """+-45 m, exact duplicates, a masked tail and an all-masked row."""
    pts = rng.uniform(-45, 45, (b, n, 3)).astype(np.float32)
    pts[:, n // 2:n // 2 + 256] = pts[:, :256]
    mask = np.ones((b, n), bool)
    mask[:, -n // 16:] = False
    mask[-1] = False
    return pts, mask


_COUNT_CASES = {"voxel_rows": _voxel_rows, "one_cell": _one_cell_rows,
                "boundary": _boundary_rows, "uniform": _uniform_rows}


@pytest.mark.parametrize("case", sorted(_COUNT_CASES))
def test_count_kernel_matches_plain(rng, dev, case):
    """Exact on every lane, masked lanes 0, with the row's mask and with
    None (every lane)."""
    pts, mask = (torch.from_numpy(a).to(dev)
                 for a in _COUNT_CASES[case](rng))
    r2 = stats_kernel.radius_sq(0.5)
    for m in (mask, None):
        c_k = stats_kernel.count_cuda(pts, m, r2)
        c_p = stats_kernel.count_plain(pts, m, r2)
        torch.cuda.synchronize()
        assert torch.equal(c_k, c_p)
    assert (c_k.sum() > 0) and (
        stats_kernel.count_cuda(pts, mask, r2)[~mask] == 0).all()


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("sext,text,n,holes", _EXTENTS)
def test_count_kernel_masks_match_plain(rng, dev, sext, text, n, holes,
                                        padded):
    p, mask = _extent_cloud(rng, dev, sext, n, holes, padded)
    r2 = stats_kernel.radius_sq(0.5)
    assert torch.equal(stats_kernel.count_cuda(p, mask, r2),
                       stats_kernel.count_plain(p, mask, r2))


@pytest.mark.parametrize("n", [8192, 8193, 32768])
def test_count_kernel_long_rows_match_plain(rng, dev, n):
    """Rows at the edge of a block's shared memory (8192 lanes bin there,
    8193 in global memory) and at the port's default capacity
    (`PrefilterConfig.capacity_filtered_points`, 32768), through
    `knn.radius_count` as prefilter calls it: exact, with a masked tail."""
    from mrg_slam_tpu_torch.config import PrefilterConfig

    assert PrefilterConfig().capacity_filtered_points == 32768
    pts, mask = _voxel_rows(rng, b=2, n=n)
    mask[:, -n // 8:] = False
    pts, mask = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    launches = stats_kernel.count_cuda.launches
    got = knn.radius_count(pts, mask, 0.5)
    assert stats_kernel.count_cuda.launches == launches + 1
    want = stats_kernel.count_plain(pts, mask, stats_kernel.radius_sq(0.5))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert want.sum() > 0
