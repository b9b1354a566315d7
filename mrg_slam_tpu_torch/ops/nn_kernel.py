"""Exact 1-nearest neighbour: the CUDA kernel (csrc/nn.cu) and its plain
PyTorch version.

Counterpart of the JAX package's ops/pallas_nn.py. Both functions take a
batch of source clouds (B, N, 3) and target clouds (B, M, 3), and return
(d2 (B, N) f32, idx (B, N) int64): the least squared distance, +inf where
it exceeds 1e11 (only a pad can be that far), and the lowest target index
reaching it. Masked targets must sit at PAD_VALUE, unless the caller
leaves them out (below). `ops.knn.nearest_neighbor` dispatches on the
device.

Lanes that take part. `src_mask` (B, N) and `tgt_mask` (B, M) are bool
masks on the clouds' device; None means every lane. A lane takes part
when its mask is set. Only targets that take part are swept, and a
source lane that does not gets the fixed result (inf, 0) without being
computed. On a source lane that takes part the result is the Pallas
kernel's, bit for bit (it sees the other targets at PAD_VALUE, where they
never win). On a masked-out source lane it may differ from the JAX
package's, and no caller reads it:
- `knn.nn_within` gates with `src_mask`, so such a lane is never valid;
- the reciprocal check (`ops.registration._correspondences`) reads the
  backward result `idx_back` only at target lanes that a valid forward
  correspondence matched, which are real target points, and ANDs the
  result into `valid`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import native

_FAR = 1e11  # a least d2 above this can only be a PAD_VALUE target
# distances an nn_plain chunk holds: 4 MB of float32, which the CPU's
# caches keep through the chunk's nine elementwise passes better than 16
_CHUNK_ELEMS = 1 << 20


def _shapes(src: torch.Tensor, tgt: torch.Tensor) -> Tuple[int, int, int]:
    if src.ndim != 3 or tgt.ndim != 3 or src.shape[-1] != 3 \
            or tgt.shape[-1] != 3 or src.shape[0] != tgt.shape[0]:
        raise ValueError(f"expected (B,N,3) and (B,M,3), got "
                         f"{tuple(src.shape)} and {tuple(tgt.shape)}")
    if tgt.shape[1] < 1:
        raise ValueError("empty target cloud")
    return src.shape[0], src.shape[1], tgt.shape[1]


def nn_cuda(src: torch.Tensor, tgt: torch.Tensor,
            src_mask: Optional[torch.Tensor] = None,
            tgt_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/nn.cu:nn_kernel on CUDA tensors."""
    b, n, m = _shapes(src, tgt)
    native.check_cuda_f32(src, tgt)
    sm = native.mask_ptr(src.device, b, n, src_mask)
    tm = native.mask_ptr(src.device, b, m, tgt_mask)
    fn = native.library("nn").mrg_nn
    d2 = torch.empty((b, n), dtype=torch.float32, device=src.device)
    idx = torch.empty((b, n), dtype=torch.int64, device=src.device)
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), tgt.data_ptr(), b, n, m, sm, tm,
                d2.data_ptr(), idx.data_ptr(), native.stream_ptr(src.device))
    native.check_rc(rc, "nn")
    nn_cuda.launches += 1
    return d2, idx


nn_cuda.launches = 0


def nn_plain(src: torch.Tensor, tgt: torch.Tensor,
             src_mask: Optional[torch.Tensor] = None,
             tgt_mask: Optional[torch.Tensor] = None,
             chunk: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in PyTorch ops, over chunks of `chunk` source
    lanes (default: as many as keep a chunk's distances within
    _CHUNK_ELEMS, so a pair bucket's B x N x M never sits in memory).

    d2 is rounded as the kernel rounds it, ((dx*dx + dy*dy) + dz*dz) with
    no fused multiply-add (each product and sum its own rounded op), so
    the two agree bit for bit. Targets that take no part are left out,
    and sources that take no part get (inf, 0), as in the kernel; the
    sources are finite (pads sit at PAD_VALUE). Among equal minima `min`
    returns the first, the lowest index (pallas_nn.py:57-60).
    """
    b, n, m = _shapes(src, tgt)
    if tgt_mask is not None:
        # a target that takes no part sits at +inf: any finite source is
        # then inf away from it (each axis (x - inf)^2 = inf), as if it
        # were masked out of every chunk
        tgt = torch.where(tgt_mask[..., None], tgt, float("inf"))
    tx, ty, tz = (tgt[..., k][:, None, :] for k in range(3))  # (B,1,M)
    chunk = max(1, min(n, chunk or _CHUNK_ELEMS // (b * m)))
    # two chunk buffers, reused: a fresh tensor an op would cost the CPU
    # an allocation and its page faults every time
    dbuf = src.new_empty((b, chunk, m))
    ebuf = torch.empty_like(dbuf)
    d2s, idxs = [], []
    for s in range(0, n, chunk):
        p = src[:, s:s + chunk]
        d, e = dbuf[:, :p.shape[1]], ebuf[:, :p.shape[1]]
        torch.sub(p[..., 0:1], tx, out=d)
        d.mul_(d)
        torch.sub(p[..., 1:2], ty, out=e)
        d.add_(e.mul_(e))
        torch.sub(p[..., 2:3], tz, out=e)
        d.add_(e.mul_(e))  # (B, C, M)
        dmin, imin = d.min(dim=-1)
        d2s.append(dmin)
        idxs.append(imin)
    d2 = torch.cat(d2s, dim=1) if d2s else src.new_empty((b, 0))
    idx = torch.cat(idxs, dim=1) if idxs else torch.zeros(
        (b, 0), dtype=torch.int64, device=src.device)
    d2 = torch.where(d2 > _FAR, torch.full_like(d2, float("inf")), d2)
    if src_mask is not None:
        d2 = d2.masked_fill(~src_mask, float("inf"))
        idx = idx.masked_fill(~src_mask, 0)
    return d2, idx
