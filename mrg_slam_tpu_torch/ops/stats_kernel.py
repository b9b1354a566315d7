"""Radius-gated neighbourhood statistics: the CUDA kernels
(csrc/radius_stats.cu) and their plain PyTorch versions.

Counterpart of the JAX package's ops/pallas_stats.py. r2 = radius^2 as a
float32 (`radius_sq`).

- count (`count_cuda`, `count_plain`): one cloud (B, N, 3) and its mask
  (B, N) bool on the cloud's device, None for every lane. -> (B, N)
  int32: per valid lane, the other valid lanes with 0 < d2 <= r2 (self
  and exact duplicates excluded), the Pallas kernel's count; a masked
  lane takes no part, whatever it holds, and gets 0. The kernel bins a
  row in a block's shared memory where it fits (rows of up to 8192 lanes
  on an H100) and in a global scratch buffer otherwise, so rows of any
  length up to 2^23 lanes run on the card; the plain version sweeps
  every pair.
- moments: source clouds (B, N, 3), target clouds (B, M, 3) ->
  (B, N, 10) f32 lanes [count, sx, sy, sz, xx, xy, xz, yy, yz, zz], raw
  sums over targets with d2 <= r2 (self included). `src_mask` (B, N) and
  `tgt_mask` (B, M) are bool masks on the clouds' device; None means
  every lane, and masked targets must then sit at PAD_VALUE. Only
  targets that take part are summed, and a source lane that does not
  gets all-zero moments without being computed. On a source lane that
  takes part the sums are taken in the Pallas kernel's ascending target
  order. On a masked-out source lane the moments may differ from the JAX
  package's, and no caller reads them:
  `covariance.estimate_covariances_radius` gives such lanes the identity
  covariance.

`moments_to_mean_cov` turns moments into mean and covariance with the
reference's formula. `ops.knn.radius_count` and
`ops.covariance.estimate_covariances_radius` dispatch on the device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import native
from .nn_kernel import _shapes

MOMENT_LANES = 10
# the count kernel's buckets: H = 2^bits, kMinHashBits <= bits <=
# kMaxHashBits of csrc/radius_stats.cu
COUNT_MIN_HASH_BITS, COUNT_MAX_HASH_BITS = 6, 24


def radius_sq(radius: float) -> float:
    """radius^2 as the JAX package forms it: the float32 radius times
    itself in float32. Its `jnp.float32(radius * radius)` runs inside a
    jitted function that traces `radius` as a float32, so the product is a
    float32 multiply, not a double product rounded once; the two differ
    for about half of all radii (tests/test_torch_radius.py)."""
    r = np.float32(radius)
    return float(r * r)


def count_cell(r2: float) -> Tuple[float, float]:
    """(c, inv_c): the count kernel's cell side c = max(r, 2^-60)
    (1 + 2^-10), r = sqrt(r2), and 1/c, each rounded to float64. The
    kernel puts a coordinate v in cell floor(v * inv_c), a float64
    product; csrc/radius_stats.cu proves that two points
    with float32 d2 <= r2 then lie at most one cell apart on every axis,
    for any finite coordinates."""
    r = math.sqrt(r2) if r2 > 0 else 0.0
    c = max(r, 2.0 ** -60) * (1.0 + 2.0 ** -10)
    return c, 1.0 / c


def count_hash_bits(n: int) -> int:
    """log2 of the count kernel's buckets H for rows of n lanes: H >= 2n,
    never below 64. Raises ValueError for rows of more than 2^23 lanes."""
    bits = max(COUNT_MIN_HASH_BITS, (2 * max(n, 1) - 1).bit_length())
    if bits > COUNT_MAX_HASH_BITS:
        raise ValueError(f"count kernel: a row of {n} lanes is longer "
                         f"than {1 << (COUNT_MAX_HASH_BITS - 1)}")
    return bits


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def count_split(device: torch.device, batch: int) -> int:
    """Blocks per row, S: S x B blocks fill the card's SMs once."""
    return max(1, min(16, _sm_count(device.index or 0) // max(batch, 1)))


def _cloud_shape(points: torch.Tensor) -> Tuple[int, int]:
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"expected (B,N,3), got {tuple(points.shape)}")
    return points.shape[0], points.shape[1]


def count_cuda(points: torch.Tensor, mask: Optional[torch.Tensor],
               r2: float) -> torch.Tensor:
    """Launch csrc/radius_stats.cu:count_kernel on a CUDA tensor, S =
    `count_split` blocks per row. A row whose bins do not fit in a block's
    shared memory bins into a scratch buffer allocated here."""
    b, n = _cloud_shape(points)
    native.check_cuda_f32(points)
    mp = native.mask_ptr(points.device, b, n, mask)
    bits = count_hash_bits(n)
    _, inv_c = count_cell(r2)
    s = count_split(points.device, b)
    out = torch.empty((b, n), dtype=torch.int32, device=points.device)
    lib = native.library("radius_stats")
    nbytes = ctypes.c_size_t(0)
    with torch.cuda.device(points.device):
        native.check_rc(lib.mrg_radius_count_scratch(
            b, n, bits, s, ctypes.byref(nbytes)), "count")
        scratch = None if nbytes.value == 0 else torch.empty(
            nbytes.value, dtype=torch.uint8, device=points.device)
        rc = lib.mrg_radius_count(
            points.data_ptr(), mp, b, n, bits, inv_c, r2, s,
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), native.stream_ptr(points.device))
    native.check_rc(rc, "count")
    count_cuda.launches += 1
    return out


count_cuda.launches = 0


def moments_cuda(src: torch.Tensor, tgt: torch.Tensor, r2: float,
                 src_mask: Optional[torch.Tensor] = None,
                 tgt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/radius_stats.cu:moments_kernel on CUDA tensors."""
    b, n, m = _shapes(src, tgt)
    native.check_cuda_f32(src, tgt)
    sm = native.mask_ptr(src.device, b, n, src_mask)
    tm = native.mask_ptr(src.device, b, m, tgt_mask)
    out = torch.empty((b, n, MOMENT_LANES), dtype=torch.float32,
                      device=src.device)
    fn = native.library("radius_stats").mrg_radius_moments
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), tgt.data_ptr(), b, n, m, r2, sm, tm,
                out.data_ptr(), native.stream_ptr(src.device))
    native.check_rc(rc, "moments")
    moments_cuda.launches += 1
    return out


moments_cuda.launches = 0


def _sqdist_chunks(src, tgt, chunk):
    """Yield (start, d2 (B, C, M)) rounded as the kernels round them."""
    tx, ty, tz = (tgt[..., k][:, None, :] for k in range(3))
    for s in range(0, src.shape[1], chunk):
        p = src[:, s:s + chunk]
        dx = p[..., 0:1] - tx
        dy = p[..., 1:2] - ty
        dz = p[..., 2:3] - tz
        yield s, dx * dx + dy * dy + dz * dz


def count_plain(points: torch.Tensor, mask: Optional[torch.Tensor],
                r2: float, chunk: int = 1024) -> torch.Tensor:
    """The same function in PyTorch ops: every pair, over source chunks.
    Lanes that take no part are left out as targets and get 0."""
    b, n = _cloud_shape(points)
    out = torch.empty((b, n), dtype=torch.int32, device=points.device)
    for s, d in _sqdist_chunks(points, points, chunk):
        w = (d <= r2) & (d > 0)
        if mask is not None:
            w = w & mask[:, None, :]
        out[:, s:s + chunk] = w.sum(-1, dtype=torch.int32)
    if mask is not None:
        out = out.masked_fill(~mask, 0)
    return out


def moments_plain(src: torch.Tensor, tgt: torch.Tensor, r2: float,
                  src_mask: Optional[torch.Tensor] = None,
                  tgt_mask: Optional[torch.Tensor] = None,
                  chunk: int = 1024) -> torch.Tensor:
    """Targets that take no part are left out and sources that take no
    part get zeros, as in the kernel; the sums go through a matmul, in
    another order than the kernel's."""
    b, n, _ = _shapes(src, tgt)
    x, y, z = tgt.unbind(-1)
    feats = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                         y * y, y * z, z * z], dim=-1)  # (B, M, 10)
    if tgt_mask is not None:  # whatever masked lanes hold, they add nothing
        feats = feats.masked_fill(~tgt_mask[..., None], 0.0)
    out = torch.empty((b, n, MOMENT_LANES), dtype=torch.float32,
                      device=src.device)
    for s, d in _sqdist_chunks(src, tgt, chunk):
        w = d <= r2
        if tgt_mask is not None:
            w = w & tgt_mask[:, None, :]
        out[:, s:s + chunk] = w.to(torch.float32) @ feats
    if src_mask is not None:
        out = out.masked_fill(~src_mask[..., None], 0.0)
    return out


def moments_to_mean_cov(mo: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., 10) raw moments -> (count, mean (..., 3), cov (..., 3, 3)).

    cov = M2/n - mean mean^T with n clamped to >= 1 (pallas_stats.py:
    161-170). The raw-sum form cancels at large coordinates; it is kept
    for parity with the reference.
    """
    cnt = mo[..., 0]
    safe = torch.clamp(cnt, min=1.0)
    mean = mo[..., 1:4] / safe[..., None]
    xx, xy, xz, yy, yz, zz = mo[..., 4:10].unbind(-1)
    m2 = torch.stack([torch.stack([xx, xy, xz], -1),
                      torch.stack([xy, yy, yz], -1),
                      torch.stack([xz, yz, zz], -1)], -2)
    m2 = m2 / safe[..., None, None]
    return cnt, mean, m2 - mean[..., :, None] * mean[..., None, :]
