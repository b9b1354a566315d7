"""Per-point GICP covariances from radius neighbourhoods (small_gicp's
plane-regularized semantics).

Counterpart of the radius mode of the JAX package's ops/covariance.py: the
raw neighbourhood moments come from csrc/radius_stats.cu on the card (the
plain PyTorch version on the CPU), the covariance from them in closed form,
and its spectrum is flattened to (eps, 1, 1). The kNN mode waits for top-k
`knn`, which is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import stats_kernel
from .cloud import PointCloud, pad_invalid
from .knn import _as_batch
from .sym3eig import smallest_eigvec3


class GICPCloud(NamedTuple):
    """A point cloud with per-point regularized covariances."""

    points: torch.Tensor  # (..., N, 3) f32
    mask: torch.Tensor    # (..., N) bool
    covs: torch.Tensor    # (..., N, 3, 3) f32


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def regularize_covs_plane(covs: torch.Tensor, eps: float = 1e-3
                          ) -> torch.Tensor:
    """Eigenvalues -> (eps, 1, 1), eigenvectors kept: I - (1-eps) n n^T with
    n the smallest eigenvector (the surface normal)."""
    _, n = smallest_eigvec3(covs)
    return _eye(covs) - (1.0 - eps) * (n[..., :, None] * n[..., None, :])


def estimate_covariances_radius(cloud: PointCloud, radius: float = 1.0
                                ) -> GICPCloud:
    """Radius-neighbourhood covariance per point, plane-regularized.

    Points with fewer than 3 neighbours (self included), and masked
    points, get I (covariance.py:118-121 of the reference).
    """
    p, lead = _as_batch(pad_invalid(cloud.points, cloud.mask))
    r2 = stats_kernel.radius_sq(radius)
    if p.device.type == "cpu":
        mo = stats_kernel.moments_plain(p, p, r2)
    else:
        mo = stats_kernel.moments_cuda(p, p, r2)
    mo = mo.reshape(lead + mo.shape[-2:])
    cnt, _, cov = stats_kernel.moments_to_mean_cov(mo)
    cov = regularize_covs_plane(cov)
    keep = cloud.mask & (cnt >= 3)
    cov = torch.where(keep[..., None, None], cov, _eye(cov))
    return GICPCloud(points=cloud.points, mask=cloud.mask, covs=cov)


def inv3x3(m: torch.Tensor, ridge: float = 1e-6) -> torch.Tensor:
    """Batched closed-form (adjugate) inverse of symmetric 3x3 matrices."""
    m = m + ridge * _eye(m)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det,
                                torch.full_like(det, 1e-20))
    row0 = torch.stack([A, B, C], dim=-1)
    row1 = torch.stack([B, a * f - c * c, b * c - a * e], dim=-1)
    row2 = torch.stack([C, b * c - a * e, a * d - b * b], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]
