"""Nearest-neighbour queries on padded clouds, dispatched on the device.

Counterpart of the JAX package's ops/knn.py. A CPU tensor goes to the plain
PyTorch version of a kernel; a CUDA tensor goes to the hand-written kernel,
which launches or raises. Distances are exact f32 coordinate differences on
both (not the |s|^2 + |t|^2 - 2 s.t expansion), so CPU and card agree.

Every function takes clouds with optional leading batch dims: (..., N, 3)
points and (..., N) masks. The nn kernel reads the masks on the device,
so masked lanes cost nothing.

Top-k `knn` is plain PyTorch on both devices: the JAX package computes it
with XLA ops (`lax.top_k` on the CPU, `approx_min_k` on the TPU), not
with a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import nn_kernel, stats_kernel

# distances a `knn` chunk holds: 16 MB of float32, 512 source rows at
# 8192 target lanes
_CHUNK_ELEMS = 1 << 22


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
    p, lead = _as_batch(points)
    m = _mask_rows(mask)
    r2 = stats_kernel.radius_sq(radius)
    if p.device.type == "cpu":
        c = stats_kernel.count_plain(p, m, r2)
    else:
        c = stats_kernel.count_cuda(p, m, r2)
    return c.reshape(lead + (points.shape[-2],))


def knn(src: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN of every `src` point in the masked `tgt` cloud.

    Returns (sq_dists (..., N, k) ascending, indices (..., N, k) int64);
    masked targets are at +inf. Distances are exact coordinate differences,
    rounded as `nn_kernel.nn_plain` rounds them, so the first neighbour is
    the 1-NN. Equal distances go to the lowest index: the top-k runs on
    unique int64 keys, the float32 bit pattern of d2 (monotone for d2 >= 0)
    over the lane, so the CPU and the card pick the same k-th neighbour
    (`torch.topk` alone promises no order among equals). Source rows run
    in chunks of at most _CHUNK_ELEMS distances.
    """
    s, lead = _as_batch(src)
    t, _ = _as_batch(tgt)
    tm = _mask_rows(tgt_mask)
    b, n, m = s.shape[0], s.shape[1], t.shape[1]
    if not 0 < k <= m:
        raise ValueError(f"k = {k} outside 1..{m} target lanes")
    tx, ty, tz = (t[..., a][:, None, :] for a in range(3))  # (B, 1, M)
    lane = torch.arange(m, device=s.device)
    rows = max(1, _CHUNK_ELEMS // max(1, b * m))
    d2s, idxs = [], []
    for c in range(0, n, rows):
        p = s[:, c:c + rows]
        dx = p[..., 0:1] - tx
        dy = p[..., 1:2] - ty
        dz = p[..., 2:3] - tz
        d = (dx * dx + dy * dy + dz * dz).masked_fill(~tm[:, None, :],
                                                      float("inf"))
        key = d.view(torch.int32).to(torch.int64)
        key.bitwise_left_shift_(32).bitwise_or_(lane)
        idx = torch.topk(key, k, dim=-1, largest=False).values & 0xFFFFFFFF
        idxs.append(idx)
        d2s.append(torch.gather(d, -1, idx))
    d2 = torch.cat(d2s, dim=1) if d2s else s.new_empty((b, 0, k))
    idx = torch.cat(idxs, dim=1) if idxs else lane.new_empty((b, 0, k))
    return (d2.reshape(lead + (n, k)), idx.reshape(lead + (n, k)))
