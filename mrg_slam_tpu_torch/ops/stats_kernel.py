"""Radius-gated neighbourhood statistics: the CUDA kernels
(csrc/radius_stats.cu) and their plain PyTorch versions.

Counterpart of the JAX package's ops/pallas_stats.py. Every function takes
a batch of source clouds (B, N, 3) and target clouds (B, M, 3), and
r2 = radius^2 as a float32 (`radius_sq`). Masked targets must sit at
PAD_VALUE, unless the caller leaves them out (below):

- count:   (B, N) int32, #targets with 0 < d2 <= r2 (self and exact
           duplicates excluded);
- moments: (B, N, 10) f32 lanes [count, sx, sy, sz, xx, xy, xz, yy, yz,
           zz], raw sums over targets with d2 <= r2 (self included).

Lanes that take part (moments only; count sweeps every lane). `src_mask`
(B, N) and `tgt_mask` (B, M) are bool masks on the clouds' device; None
means every lane. A lane takes part when its mask is set. Only targets
that take part are summed, and a source lane that does not gets all-zero
moments without being computed. On a source lane that takes part, the
count is the Pallas kernel's and the sums are taken in the same ascending
target order. On a masked-out source lane the moments may
differ from the JAX package's, and no caller reads them:
- `knn.radius_count` (count) zeroes masked lanes;
- `covariance.estimate_covariances_radius` (moments) gives masked lanes
  the identity covariance.

`moments_to_mean_cov` turns moments into mean and covariance with the
reference's formula. `ops.knn.radius_count` and
`ops.covariance.estimate_covariances_radius` dispatch on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import native
from .nn_kernel import _shapes

MOMENT_LANES = 10


def radius_sq(radius: float) -> float:
    """radius^2 as the JAX package forms it: the float32 radius times
    itself in float32. Its `jnp.float32(radius * radius)` runs inside a
    jitted function that traces `radius` as a float32, so the product is a
    float32 multiply, not a double product rounded once; the two differ
    for about half of all radii (tests/test_torch_radius.py)."""
    r = np.float32(radius)
    return float(r * r)


def _launch(name: str, symbol: str, src, tgt, r2, out, *masks) -> None:
    b, n, m = _shapes(src, tgt)
    fn = getattr(native.library("radius_stats"), symbol)
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), tgt.data_ptr(), b, n, m, r2, *masks,
                out.data_ptr(), native.stream_ptr(src.device))
    native.check_rc(rc, name)


def count_cuda(src: torch.Tensor, tgt: torch.Tensor, r2: float
               ) -> torch.Tensor:
    """Launch csrc/radius_stats.cu:count_kernel on CUDA tensors."""
    b, n, _ = _shapes(src, tgt)
    native.check_cuda_f32(src, tgt)
    out = torch.empty((b, n), dtype=torch.int32, device=src.device)
    _launch("count", "mrg_radius_count", src, tgt, r2, out)
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
    _launch("moments", "mrg_radius_moments", src, tgt, r2, out, sm, tm)
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


def count_plain(src: torch.Tensor, tgt: torch.Tensor, r2: float,
                chunk: int = 1024) -> torch.Tensor:
    b, n, _ = _shapes(src, tgt)
    out = torch.empty((b, n), dtype=torch.int32, device=src.device)
    for s, d in _sqdist_chunks(src, tgt, chunk):
        out[:, s:s + chunk] = ((d <= r2) & (d > 0)).sum(-1, dtype=torch.int32)
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
