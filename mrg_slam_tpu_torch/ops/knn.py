"""Nearest-neighbour queries on padded clouds, dispatched on the device.

Counterpart of the JAX package's ops/knn.py. A CPU tensor goes to the plain
PyTorch version of a kernel; a CUDA tensor goes to the hand-written kernel,
which launches or raises. Distances are exact f32 coordinate differences on
both (not the |s|^2 + |t|^2 - 2 s.t expansion), so CPU and card agree.

Every function takes clouds with optional leading batch dims: (..., N, 3)
points and (..., N) masks. The nn kernel reads the masks on the device,
so masked lanes cost nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import nn_kernel, stats_kernel
from .cloud import pad_invalid


def _as_batch(x: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
    lead = x.shape[:-2]
    return x.reshape((-1,) + x.shape[-2:]).contiguous(), lead


def _mask_rows(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(..., N) mask -> (B, N), as _as_batch lays out the rows."""
    return None if mask is None \
        else mask.reshape((-1, mask.shape[-1])).contiguous()


def nearest_neighbor(src: torch.Tensor, tgt: torch.Tensor,
                     tgt_mask: torch.Tensor,
                     src_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of every `src` point in the masked `tgt` cloud.

    Returns (sq_dists (..., N), indices (..., N) int64). Ties go to the
    lowest index; with no valid target the distance is +inf and the index
    0 (pallas_nn.py semantics). `src_mask` marks the source lanes the
    caller reads (None: all); the others get (inf, 0) (nn_kernel.py).
    """
    s, lead = _as_batch(src)
    t, _ = _as_batch(tgt)
    masks = (_mask_rows(src_mask), _mask_rows(tgt_mask))
    if s.device.type == "cpu":
        d2, idx = nn_kernel.nn_plain(s, t, *masks)
    else:
        d2, idx = nn_kernel.nn_cuda(s, t, *masks)
    n = src.shape[-2]
    return d2.reshape(lead + (n,)), idx.reshape(lead + (n,))


def nn_within(src: torch.Tensor, src_mask: torch.Tensor, tgt: torch.Tensor,
              tgt_mask: torch.Tensor, max_dist: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-NN with the correspondence gate of GICP/ICP: returns (sq_dists,
    indices, valid), valid = source valid and d2 <= max_dist^2."""
    d2, idx = nearest_neighbor(src, tgt, tgt_mask, src_mask)
    valid = src_mask & (d2 <= stats_kernel.radius_sq(max_dist))
    return d2, idx, valid


def radius_count(points: torch.Tensor, mask: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """Number of OTHER valid points within `radius` of each point
    (pcl::RadiusOutlierRemoval semantics); 0 for masked points."""
    p, lead = _as_batch(pad_invalid(points, mask))
    r2 = stats_kernel.radius_sq(radius)
    if p.device.type == "cpu":
        c = stats_kernel.count_plain(p, p, r2)
    else:
        c = stats_kernel.count_cuda(p, p, r2)
    c = c.reshape(lead + (points.shape[-2],))
    return torch.where(mask, c, torch.zeros_like(c))
