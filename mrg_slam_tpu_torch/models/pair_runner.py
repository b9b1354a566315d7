"""Batched cloud-pair execution for the back-end tick.

Counterpart of the JAX package's models/pair_runner.py. The reference
back end runs many independent cloud-against-cloud operations per tick,
each a serial registration or kd-tree pass: a fitness pass for each new
graph edge's information matrix (information_matrix_calculator.cpp:46-81),
one registration per loop candidate (loop_detector.cpp:97-188) and two
more for the consistency check (:190-303). Here every pair of a tick is a
row of `ops.registration.align_pairs_packed`, whose nn sweeps run all rows
of a bucket in one launch of the nn kernel:

- each keyframe's GICP covariances are computed once and kept on the
  keyframe (`PairRunner.gicp`), or handed over by the front end; with a
  voxel-family method (VGICP, NDT) each keyframe's Gaussian voxel map is
  kept the same way (`PairRunner.voxel_map`), and the bucket runs
  `align_pairs_voxel_packed`, the fitness pass against the raw clouds;
- a bucket's rows need no padding: nothing recompiles for a new batch
  size, and a finished row costs its nn blocks nothing
  (registration._live_lanes).

The bucket cap and the speculation budget keep the JAX package's values,
which were measured on a TPU; measuring them again on the H100 is open
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

from ..config import RegistrationConfig
from ..ops import registration as reg
from ..ops.cloud import PAD_VALUE, PointCloud
from ..ops.covariance import GICPCloud
from ..ops.gaussian_voxel import GaussianVoxelMap
from ..ops.voxel import _INVALID_KEY
from .keyframe import KeyFrame


@dataclasses.dataclass
class PairRequest:
    """One row of the tick's pair program.

    `max_iters = 0` means evaluate only: no registration, just the fitness
    of `source` moved by `init_pose` into `target` (edge information
    weighting). `max_iters > 0` runs the Gauss-Newton first.
    """

    target: KeyFrame
    source: KeyFrame
    init_pose: np.ndarray
    max_iters: int = 0
    fitness_max_range: float = math.inf


@dataclasses.dataclass
class PairResult:
    pose: np.ndarray
    converged: bool
    iterations: int
    num_inliers: int
    fitness_inf: float
    fitness_range: float


class PairRunner:
    """Executes PairRequest batches through the pair program."""

    MIN_BUCKET = 4
    # rows per bucket: point-rows up to this budget (the JAX package's
    # values, measured on a TPU: 64 rows of 8192 points)
    ROW_POINTS_BUDGET = 524288           # rows above 4096 points
    ROW_POINTS_BUDGET_SMALL = 1 << 20    # rows up to 4096 points
    # point-rows of speculative consistency-check rows a tick may add
    # before it detects loops in two phases (LoopDetector.detect)
    FREE_ROW_POINTS = 64 * 1024
    # keyframes per batched covariance pass
    PREFETCH_BUCKET = 16

    def __init__(self, reg_cfg: RegistrationConfig):
        # GICP-family targets are covariance clouds, VGICP/NDT targets
        # Gaussian voxel maps; both run the packed one-read bucket program
        self.voxel_target = not reg.is_gicp_like(
            reg_cfg.registration_method)
        self.reg_cfg = reg_cfg
        # (rows, GN iterations of its slowest row) of each bucket run
        # since the caller last cleared it
        self.buckets: List[Tuple[int, int]] = []

    def max_bucket(self, capacity: int) -> int:
        budget = (self.ROW_POINTS_BUDGET_SMALL if capacity <= 4096
                  else self.ROW_POINTS_BUDGET)
        b = self.MIN_BUCKET
        while b * 2 * capacity <= budget:
            b *= 2
        return b

    def speculation_budget_rows(self, capacity: int) -> int:
        return max(self.FREE_ROW_POINTS // max(capacity, 1),
                   self.MIN_BUCKET)

    # ------------------------------------------------------------------
    def gicp(self, kf: KeyFrame) -> GICPCloud:
        """The keyframe's GICP cloud (points, mask, covariances), made once
        and kept on the keyframe."""
        if kf.gicp is None:
            kf.gicp = reg.make_source(kf.cloud, self.reg_cfg)
        return kf.gicp

    def voxel_map(self, kf: KeyFrame) -> GaussianVoxelMap:
        """The keyframe's Gaussian voxel map (VGICP/NDT targets; as many
        voxels as the cloud has lanes), made once and kept on the
        keyframe, as VGICP/NDT rebuild the target grid once per
        setInputTarget in the reference stack."""
        if kf.voxel_map is None:
            kf.voxel_map = reg.make_target(
                kf.cloud, self.reg_cfg,
                voxel_capacity=kf.cloud.capacity).voxels
        return kf.voxel_map

    def prefetch(self, kf: KeyFrame) -> None:
        """A new keyframe's covariances, and its voxel map with a voxel
        method, made ahead of the tick."""
        self.gicp(kf)
        if self.voxel_target:
            self.voxel_map(kf)

    def prefetch_batch(self, kfs: List[KeyFrame]) -> None:
        """Covariances of every keyframe that has none, PREFETCH_BUCKET
        keyframes per batched pass of the moments kernel; with a voxel
        method, their voxel maps too (one build a capacity group)."""
        todo = [k for k in kfs if k.gicp is None and k.cloud.capacity > 0]
        if self.voxel_target:
            self._voxel_maps([k for k in kfs if k.voxel_map is None
                              and k.cloud.capacity > 0])
        # passes by capacity (a filled first keyframe's cloud is larger)
        groups = {}
        for k in todo:
            groups.setdefault(k.cloud.capacity, []).append(k)
        for chunk in [g[s: s + self.PREFETCH_BUCKET] for g in groups.values()
                      for s in range(0, len(g), self.PREFETCH_BUCKET)]:
            out = reg.make_source(PointCloud(
                torch.stack([k.cloud.points for k in chunk]),
                torch.stack([k.cloud.mask for k in chunk])), self.reg_cfg)
            for i, k in enumerate(chunk):
                k.gicp = GICPCloud(*(x[i] for x in out))

    def _voxel_maps(self, kfs: List[KeyFrame]) -> None:
        """The voxel maps of `kfs`, built batched per cloud capacity (a
        row's map is the map of its cloud alone)."""
        groups = {}
        for k in kfs:
            groups.setdefault(k.cloud.capacity, []).append(k)
        for cap, group in groups.items():
            for s in range(0, len(group), self.PREFETCH_BUCKET):
                chunk = group[s: s + self.PREFETCH_BUCKET]
                out = reg.make_target(PointCloud(
                    torch.stack([k.cloud.points for k in chunk]),
                    torch.stack([k.cloud.mask for k in chunk])),
                    self.reg_cfg, voxel_capacity=cap).voxels
                for i, k in enumerate(chunk):
                    k.voxel_map = GaussianVoxelMap(*(x[i] for x in out))

    # ------------------------------------------------------------------
    def run(self, requests: List[PairRequest]) -> List[PairResult]:
        if not requests:
            return []
        cap = max(max(r.target.cloud.capacity, r.source.cloud.capacity)
                  for r in requests)
        step = self.max_bucket(cap)
        out: List[PairResult] = []
        for s in range(0, len(requests), step):
            out.extend(self._run_bucket(requests[s: s + step]))
        return out

    @staticmethod
    def _padded(gc: GICPCloud, cap: int) -> GICPCloud:
        """A keyframe's GICP cloud padded to `cap` lanes (masked out,
        identity covariances), which take no part in a solve. Only a
        filled first keyframe's cloud (graph_database.py) is larger than
        the others; the JAX package's bucket asserts on it instead
        (pair_runner.py:197-202)."""
        k = cap - gc.points.shape[-2]
        if not k:
            return gc
        pts = torch.full((k, 3), PAD_VALUE, dtype=gc.points.dtype,
                         device=gc.points.device)
        eye = torch.eye(3, dtype=gc.covs.dtype, device=gc.covs.device)
        return GICPCloud(torch.cat([gc.points, pts]),
                         torch.cat([gc.mask, gc.mask.new_zeros(k)]),
                         torch.cat([gc.covs, eye.expand(k, 3, 3)]))

    @staticmethod
    def _padded_map(vm: GaussianVoxelMap, cap: int) -> GaussianVoxelMap:
        """A voxel map padded to `cap` voxels with invalid keys (sorted
        last, never found by a lookup), zero means and identity
        covariances, so maps of several capacities stack in one bucket."""
        k = cap - vm.keys.shape[-1]
        if not k:
            return vm
        eye = torch.eye(3, dtype=vm.covs.dtype, device=vm.covs.device)
        return vm._replace(
            keys=torch.cat([vm.keys, vm.keys.new_full((k,), _INVALID_KEY)]),
            means=torch.cat([vm.means, vm.means.new_zeros((k, 3))]),
            covs=torch.cat([vm.covs, eye.expand(k, 3, 3)]),
            counts=torch.cat([vm.counts, vm.counts.new_zeros(k)]),
            valid=torch.cat([vm.valid, vm.valid.new_zeros(k)]))

    def _run_bucket(self, requests: List[PairRequest]) -> List[PairResult]:
        srcs = [self.gicp(r.source) for r in requests]
        tgts = [self.gicp(r.target) for r in requests]
        cap = max(c.points.shape[-2] for c in tgts + srcs)
        tgts = [self._padded(c, cap) for c in tgts]
        srcs = [self._padded(c, cap) for c in srcs]
        host = (np.stack([np.asarray(r.init_pose, np.float32)
                          for r in requests]),
                np.asarray([r.max_iters for r in requests], np.int32),
                np.asarray([r.fitness_max_range for r in requests],
                           np.float32))
        if self.voxel_target:
            # the maps to register against, the raw target clouds for the
            # fitness pass
            maps = [self.voxel_map(r.target) for r in requests]
            vcap = max(m.keys.shape[-1] for m in maps)
            packed = reg.align_pairs_voxel_packed(
                self.reg_cfg, [self._padded_map(m, vcap) for m in maps],
                [PointCloud(c.points, c.mask) for c in tgts], srcs, *host)
        else:
            packed = reg.align_pairs_packed(self.reg_cfg, tgts, srcs, *host)
        packed = packed.cpu().numpy()  # the bucket's one read
        self.buckets.append((len(requests), int(packed[:, 8].max())))
        return [PairResult(pose=packed[i, :7],
                           converged=bool(packed[i, 7] > 0.5),
                           iterations=int(packed[i, 8]),
                           num_inliers=int(packed[i, 9]),
                           fitness_inf=float(packed[i, 10]),
                           fitness_range=float(packed[i, 11]))
                for i in range(len(requests))]
