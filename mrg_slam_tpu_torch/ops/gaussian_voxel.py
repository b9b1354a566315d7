"""Gaussian voxel maps: the target of the voxel registration family.

Counterpart of the JAX package's ops/gaussian_voxel.py.
pclomp::NormalDistributionsTransform and fast_gicp::FastVGICP reduce the
target cloud to per-voxel Gaussians (mean and covariance) and look voxels
up by their quantized coordinates. Here the build is one sort and segment
sums, and the lookup a binary search (`searchsorted`) over the sorted
voxel keys; both are plain torch ops, as they are XLA ops in the JAX
package.

Keys are the packed int32 voxel keys of ops/voxel.py, anchored at the
cloud's min corner, sorted by (scrambled key, key) as the JAX package's
`lexsort` sorts them, so segments come in the JAX package's order and a
capacity overflow drops the same voxels. Segment sums are differences of
a float64 prefix sum (no scatter-add, whose CUDA form is not
deterministic), rounded to float32, and the covariance is then formed as
the JAX package forms it in float32; means and covariances so agree with
the JAX package's to float32 rounding, not bit for bit.

DIRECT1/DIRECT7/DIRECT27 (pclomp's reg_nn_search_method,
registrations.cpp:121-147): a query probes the voxel holding it and its
0/6/26 neighbours, and the probe whose mean is nearest wins (the first
such probe on a tie). Maps and queries may carry leading batch axes, one
map a row.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .cloud import PointCloud
from .covariance import regularize_covs_plane
from .voxel import _INVALID_KEY, pack_key, scramble_key, voxel_coords

_OFFSETS = {
    "DIRECT1": [[0, 0, 0]],
    "DIRECT7": [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                [0, 0, 1], [0, 0, -1]],
}
_OFFSETS["DIRECT27"] = [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                        for k in (-1, 0, 1)]


class GaussianVoxelMap(NamedTuple):
    """Sorted voxel-Gaussian table (leading batch axes allowed).

    keys:   (C,) int32 sorted packed voxel keys, the invalid key at the end
    means:  (C, 3); covs: (C, 3, 3) regularized; counts: (C,) float32
    origin: (3,) quantization origin (the resolution rides with the
            registration parameters)
    valid:  (C,) bool
    """

    keys: torch.Tensor
    means: torch.Tensor
    covs: torch.Tensor
    counts: torch.Tensor
    origin: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]


def build_gaussian_voxel_map(cloud: PointCloud, resolution: float,
                             capacity: int, min_points: int = 4,
                             regularize: bool = True) -> GaussianVoxelMap:
    """Reduce a cloud ((..., N, 3) points, (..., N) mask) to per-voxel
    (mean, covariance) Gaussians, at most `capacity` voxels.

    `min_points` is NDT's minimum points a cell (cells with fewer have a
    degenerate covariance and are dropped; VGICP keeps small cells and
    relies on the regularization)."""
    pts, valid = cloud.points, cloud.mask
    big = torch.where(valid[..., None], pts,
                      torch.full_like(pts, float("inf")))
    origin = big.amin(dim=-2)
    origin = torch.where(torch.isfinite(origin), origin,
                         torch.zeros_like(origin))
    key = pack_key(voxel_coords(pts, resolution, origin[..., None, :]),
                   valid)
    # one stable sort on (scramble, key) == lexsort((key, scramble(key)))
    comp = (scramble_key(key).long() << 31) | key.long()
    comp_s, order = torch.sort(comp, dim=-1, stable=True)
    key_s = (comp_s & _INVALID_KEY).to(torch.int32)
    pts_s = torch.gather(pts, -2, order[..., None].expand(pts.shape))
    valid_s = key_s != _INVALID_KEY  # the invalid keys sort last

    first = torch.ones_like(key_s[..., :1], dtype=torch.bool)
    new_seg = torch.cat([first, key_s[..., 1:] != key_s[..., :-1]], dim=-1)
    seg = torch.cumsum(new_seg.long(), dim=-1) - 1
    seg = torch.where(valid_s, seg, torch.iinfo(torch.int64).max)
    wanted = torch.arange(capacity, device=pts.device).expand(
        seg.shape[:-1] + (capacity,)).contiguous()
    start = torch.searchsorted(seg, wanted, right=False)
    end = torch.searchsorted(seg, wanted, right=True)
    counts = (end - start).to(torch.float32)

    # sums of x and x x^T by differences of a float64 prefix sum along
    # the innermost dim, rounded to float32 as the JAX package's sums are
    p64 = pts_s.double()
    feats = torch.cat([p64, (p64[..., :, None] * p64[..., None, :])
                       .flatten(-2)], dim=-1)            # (..., N, 12)
    csum = torch.cumsum(feats.transpose(-1, -2).contiguous(), dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    idx = seg.shape[:-1] + (12, capacity)
    sums = (torch.gather(csum, -1, end[..., None, :].expand(idx))
            - torch.gather(csum, -1, start[..., None, :].expand(idx)))
    sums = sums.transpose(-1, -2).to(torch.float32)     # (..., C, 12)
    seg_keys = torch.gather(
        key_s, -1, torch.clamp(start, max=key_s.shape[-1] - 1))

    cnt = torch.clamp(counts, min=1.0)
    means = sums[..., :3] / cnt[..., None]
    covs = (sums[..., 3:].unflatten(-1, (3, 3)) / cnt[..., None, None]
            - means[..., :, None] * means[..., None, :])
    vmask = counts >= float(min_points)
    if regularize:
        covs = regularize_covs_plane(covs)
    eye = torch.eye(3, dtype=covs.dtype, device=covs.device)
    covs = torch.where(vmask[..., None, None], covs, eye)
    means = torch.where(vmask[..., None], means, torch.zeros_like(means))
    keys_out = torch.where(vmask, seg_keys,
                           torch.full_like(seg_keys, _INVALID_KEY))
    # the table sorted with the invalid keys at the end, for searchsorted
    keys_sorted, order2 = torch.sort(keys_out, dim=-1, stable=True)

    def take(a):
        ix = order2.reshape(order2.shape + (1,) * (a.ndim - order2.ndim))
        return torch.gather(a, order2.ndim - 1, ix.expand(a.shape))

    return GaussianVoxelMap(keys=keys_sorted, means=take(means),
                            covs=take(covs), counts=take(counts),
                            origin=origin, valid=take(vmask))


def lookup(vmap: GaussianVoxelMap, points: torch.Tensor, mask: torch.Tensor,
           resolution: float, method: str = "DIRECT1"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The voxel of each query point ((..., N, 3), (..., N) mask), or for
    DIRECT7/27 the probed voxel whose mean is nearest -> (indices (..., N)
    int64 into the map, found (..., N) bool). Leading axes of the points
    match the map's."""
    coords = voxel_coords(points, resolution, vmap.origin[..., None, :])
    offsets = torch.tensor(_OFFSETS[method], dtype=torch.int32,
                           device=points.device)
    keys = vmap.keys.contiguous()
    last = keys.shape[-1] - 1
    best_d2 = best_idx = best_hit = None
    for off in offsets:  # the first probe wins a tie, as argmin takes it
        k = pack_key(coords + off, mask)
        idx = torch.clamp(torch.searchsorted(keys, k.contiguous()), max=last)
        hit = (torch.gather(keys, -1, idx) == k) & (k != _INVALID_KEY)
        q = torch.gather(vmap.means, -2, idx[..., None].expand(
            idx.shape + (3,)))
        d2 = torch.where(hit, torch.sum((q - points) ** 2, dim=-1),
                         torch.full_like(points[..., 0], float("inf")))
        if best_d2 is None:
            best_d2, best_idx, best_hit = d2, idx, hit
        else:
            better = d2 < best_d2
            best_d2 = torch.where(better, d2, best_d2)
            best_idx = torch.where(better, idx, best_idx)
            best_hit = torch.where(better, hit, best_hit)
    return best_idx, best_hit
