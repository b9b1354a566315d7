"""Fitness score: mean squared NN distance between aligned clouds.

Counterpart of the JAX package's ops/fitness.py, shared by loop-closure
acceptance (loop_detector.cpp:156) and edge information weighting
(information_matrix_calculator.cpp:46-81): move `cloud2` by `relpose`
into `cloud1`'s frame, find each point's nearest neighbour in `cloud1`
(the nn kernel on the card) and average the squared distances of those
within `max_range`. With nothing in range it is +inf, where the reference
falls back to the largest double.
"""

from __future__ import annotations

import math

import torch

from ..utils import se3
from . import knn, stats_kernel
from .cloud import PointCloud


def fitness_score(cloud1: PointCloud, cloud2: PointCloud,
                  relpose: torch.Tensor,
                  max_range: float = math.inf) -> torch.Tensor:
    """Mean squared 1-NN distance of cloud2 (moved by relpose) into
    cloud1; a 0-dim tensor on the clouds' device."""
    moved = se3.pose_apply(relpose, cloud2.points)
    d2, _ = knn.nearest_neighbor(moved, cloud1.points, cloud1.mask,
                                 cloud2.mask)
    ok = (cloud2.mask & (d2 <= stats_kernel.radius_sq(max_range))
          & torch.isfinite(d2))
    n = ok.sum(dtype=torch.int32)
    total = torch.where(ok, d2, torch.zeros_like(d2)).sum()
    return torch.where(n > 0, total / torch.clamp(n, min=1),
                       torch.full_like(total, float("inf")))
