"""Exact 1-nearest neighbour: the CUDA kernel (csrc/nn.cu) and its plain
PyTorch version.

Counterpart of the JAX package's ops/pallas_nn.py. Both functions take a
batch of source clouds (B, N, 3) and target clouds (B, M, 3) whose masked
targets the caller has already moved to PAD_VALUE, and return
(d2 (B, N) f32, idx (B, N) int64): the least squared distance, +inf where
it exceeds 1e11 (only a pad can be that far), and the lowest target index
reaching it. `ops.knn.nearest_neighbor` dispatches on the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import native

_FAR = 1e11  # a least d2 above this can only be a PAD_VALUE target


def _shapes(src: torch.Tensor, tgt: torch.Tensor) -> Tuple[int, int, int]:
    if src.ndim != 3 or tgt.ndim != 3 or src.shape[-1] != 3 \
            or tgt.shape[-1] != 3 or src.shape[0] != tgt.shape[0]:
        raise ValueError(f"expected (B,N,3) and (B,M,3), got "
                         f"{tuple(src.shape)} and {tuple(tgt.shape)}")
    if tgt.shape[1] < 1:
        raise ValueError("empty target cloud")
    return src.shape[0], src.shape[1], tgt.shape[1]


def nn_cuda(src: torch.Tensor, tgt: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/nn.cu:nn_kernel on CUDA tensors."""
    b, n, m = _shapes(src, tgt)
    native.check_cuda_f32(src, tgt)
    fn = native.library("nn").mrg_nn
    d2 = torch.empty((b, n), dtype=torch.float32, device=src.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=src.device)
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), tgt.data_ptr(), b, n, m, d2.data_ptr(),
                idx.data_ptr(), native.stream_ptr(src.device))
    native.check_rc(rc, "nn")
    nn_cuda.launches += 1
    return d2, idx.long()


nn_cuda.launches = 0


def nn_plain(src: torch.Tensor, tgt: torch.Tensor, chunk: int = 1024
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in PyTorch ops, over source chunks.

    d2 is rounded as the kernel rounds it, ((dx*dx + dy*dy) + dz*dz) with
    no fused multiply-add, so the two agree bit for bit.
    """
    b, n, m = _shapes(src, tgt)
    tx, ty, tz = (tgt[..., k][:, None, :] for k in range(3))  # (B,1,M)
    cols = torch.arange(m, device=src.device)
    d2s, idxs = [], []
    for s in range(0, n, chunk):
        p = src[:, s:s + chunk]
        dx = p[..., 0:1] - tx
        dy = p[..., 1:2] - ty
        dz = p[..., 2:3] - tz
        d = dx * dx + dy * dy + dz * dz  # (B, C, M)
        dmin = d.min(dim=-1).values
        # lowest index among equal minima (pallas_nn.py:57-60)
        idxs.append(torch.where(d == dmin[..., None], cols, m).min(-1).values)
        d2s.append(dmin)
    d2 = torch.cat(d2s, dim=1) if d2s else src.new_empty((b, 0))
    idx = torch.cat(idxs, dim=1) if idxs else cols.new_empty((b, 0))
    d2 = torch.where(d2 > _FAR, torch.full_like(d2, float("inf")), d2)
    return d2, idx
