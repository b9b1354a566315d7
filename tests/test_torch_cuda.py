"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA card (marker `cuda`); without one every test skips. On a
machine with a card and without JAX (tests/conftest.py imports it):
`python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""`.
chip_smoke.py makes the same checks at the main path's full shapes.

Tolerances: nn indices and d2 bitwise (both round d2 step by step with no
FMA), counts exact, moments within the float32 summation bound of two
orders (see chip_smoke.check_moments). With masks (B rows whose valid
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
    assert torch.equal(stats_kernel.count_cuda(p, p, r2),
                       stats_kernel.count_plain(p, p, r2))
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
