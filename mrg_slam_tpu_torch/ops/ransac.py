"""Batched plane RANSAC and normal estimation.

Counterpart of the JAX package's ops/ransac.py, which replaces
pcl::SampleConsensusModelPlane/RANSAC and pcl::NormalEstimation
(floor_detection_component.cpp:139-161, :216-253). All H hypotheses are
fitted and scored at once: a closed-form plane per 3-point triplet, an
(N, H) distance-and-compare reduction for the inliers, then the winner
refined by a least-squares fit over its inliers (the smallest
eigenvector of their scatter).

The sampling is split from the fit. The JAX package draws the triplets
with jax.random inside its jitted fit; the port draws them with
`sample_triplets` from a torch.Generator on the cloud's device, uniform
values scaled by the valid count there, with no host read. So the same
triplets, whatever their source, give the JAX package's fit, and tests
replay its key stream exactly.

Precision: the distances and offsets are float32 with TF32 off (the
port's numerics); the plane offsets d are elementwise products and sums,
as the JAX package keeps them to stay off a reduced-precision matmul at
~45 m coordinates.

Plane convention: (n, d) with n unit and n.x + d = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import knn
from .cloud import PointCloud
from .sym3eig import smallest_eigvec3


class PlaneFit(NamedTuple):
    coeffs: torch.Tensor       # (4,) [nx, ny, nz, d]
    num_inliers: torch.Tensor  # () int64
    inlier_mask: torch.Tensor  # (N,) bool
    valid: torch.Tensor        # () bool: enough points to attempt a fit


def sample_triplets(mask: torch.Tensor, num_hypotheses: int,
                    generator: torch.Generator) -> torch.Tensor:
    """(H, 3) int64 uniform draws in [0, max(n_valid, 1)), ranks among
    the valid lanes (`ransac_plane` maps them through the valid-first
    order): floor(u n_valid) of float64 uniforms, on the mask's device."""
    n = torch.clamp(mask.sum(), min=1)
    u = torch.rand((num_hypotheses, 3), generator=generator,
                   dtype=torch.float64, device=mask.device)
    return torch.minimum(torch.floor(u * n).long(), n - 1)


def ransac_plane(cloud: PointCloud, triplets: torch.Tensor,
                 distance_thresh: float) -> PlaneFit:
    """The best of the planes through `triplets` ((H, 3) ranks among the
    valid points, `sample_triplets`), refined on its inliers."""
    pts, mask = cloud.points, cloud.mask
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    tri = pts[order[triplets]]  # (H, 3, 3)
    normal = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                                dim=-1)
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    normal = normal / torch.clamp(norm, min=1e-12)
    d = -torch.sum(normal * tri[:, 0], dim=-1)
    degenerate = norm[:, 0] < 1e-8
    dist = torch.abs(pts @ normal.T + d[None, :])
    within = (dist <= distance_thresh) & mask[:, None]
    scores = torch.where(degenerate, -1, within.sum(0))
    # the first of equal scores, kept a (1,) tensor: indexing with a 0-dim
    # tensor reads it on the host
    best = torch.argmax(scores)[None]
    n_best = normal.index_select(0, best)[0]

    # least-squares refinement on the winner's inliers
    w = within.index_select(1, best)[:, 0].to(pts.dtype)
    cnt = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / cnt
    diff = (pts - mean) * w[:, None]
    _, n_ref = smallest_eigvec3(diff.T @ diff / cnt)
    n_ref = torch.where(torch.dot(n_ref, n_best) < 0, -n_ref, n_ref)
    d_ref = -torch.sum(n_ref * mean)
    inliers = (torch.abs(pts @ n_ref + d_ref) <= distance_thresh) & mask
    return PlaneFit(coeffs=torch.cat([n_ref, d_ref[None]]),
                    num_inliers=inliers.sum(), inlier_mask=inliers,
                    valid=mask.sum() >= 3)


def estimate_normals(cloud: PointCloud, k: int = 10) -> torch.Tensor:
    """(N, 3) unit normals, the smallest eigenvector of each point's k
    nearest neighbours' scatter (top-k `knn`), oriented to +z."""
    d2, idx = knn.knn(cloud.points, cloud.points, cloud.mask, k)
    neigh = cloud.points[idx]                           # (N, k, 3)
    nmask = (cloud.mask[idx] & torch.isfinite(d2)).to(neigh.dtype)
    cnt = torch.clamp(nmask.sum(-1), min=1.0)
    mean = torch.sum(neigh * nmask[..., None], dim=-2) / cnt[..., None]
    diff = (neigh - mean[:, None, :]) * nmask[..., None]
    cov = diff.transpose(-1, -2) @ diff / cnt[..., None, None]
    _, normals = smallest_eigvec3(cov)
    return torch.where(normals[..., 2:3] < 0, -normals, normals)
