"""Fixed-capacity padded point cloud.

A cloud is `points` (..., N, 3) f32 plus a `mask` (..., N) bool, with
leading batch dims allowed. Invalid lanes sit at the sentinel PAD_VALUE,
so distance tests exclude them without extra branching. Same contract as
the JAX package's ops/cloud.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..runtime import DeviceLike, resolve_device

# far enough that any distance test excludes it, small enough that its
# square stays finite in float32
PAD_VALUE = 1.0e6


class PointCloud(NamedTuple):
    points: torch.Tensor  # (..., N, 3) f32
    mask: torch.Tensor    # (..., N) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @staticmethod
    def from_array(pts, capacity: Optional[int] = None,
                   device: DeviceLike = None) -> "PointCloud":
        """(n, >=3) array -> padded cloud; more than `capacity` truncates."""
        pts = np.asarray(pts, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] < 3:
            raise ValueError(f"expected (N,>=3) points, got {pts.shape}")
        cap = capacity if capacity is not None else pts.shape[0]
        n = min(pts.shape[0], cap)
        out = np.full((cap, 3), PAD_VALUE, dtype=np.float32)
        out[:n] = pts[:n, :3]
        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        dev = resolve_device(device)
        return PointCloud(torch.from_numpy(out).to(dev),
                          torch.from_numpy(mask).to(dev))

    def transformed(self, pose: torch.Tensor) -> "PointCloud":
        """Rigid-transform valid points by a 7-vector pose; padding kept."""
        from ..utils import se3

        pts = se3.pose_apply(pose, self.points)
        return PointCloud(pad_invalid(pts, self.mask), self.mask)


def pad_invalid(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Points with the masked-out lanes set to PAD_VALUE."""
    return torch.where(mask[..., None], points,
                       torch.full_like(points, PAD_VALUE))


def compact(cloud: PointCloud, capacity: Optional[int] = None) -> PointCloud:
    """Valid points to the front (stable), tail padded, cut to `capacity`."""
    cap = capacity or cloud.capacity
    order = torch.argsort((~cloud.mask).to(torch.int8), dim=-1, stable=True)
    pts = torch.gather(cloud.points, -2,
                       order[..., None].expand(cloud.points.shape))
    mask = torch.gather(cloud.mask, -1, order)
    pts, mask = pts[..., :cap, :], mask[..., :cap]
    return PointCloud(pad_invalid(pts, mask), mask)
