"""Host-side graph construction: the `GraphSLAM` API surface.

Counterpart of the JAX package's graph/builder.py (include/mrg_slam/
graph_slam.hpp:34-174): an incremental builder over capacity-sized numpy
staging buffers, written in place at add time, that snapshot to the
device as a `PoseGraphData` for each solve. Stores double on overflow, so
a run never dies on a preallocation guess (the reference's g2o graph
grows without bound); a snapshot then carries the larger shape. Node and
edge ids are dense ints; uuid bookkeeping lives in
models/graph_database.py.

Only SE(3) nodes and SE3-SE3 edges are ported; the prior and plane tables
of a snapshot have zero capacity (ROADMAP.md queue 1 item 12).
`optimize_many`, the batched solve of co-hosted robots' graphs, waits for
item 14.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import OptimizerConfig
from ..runtime import DeviceLike, resolve_device
from . import chain_solver, solve
from .chordal import chordal_init
from .types import KERNEL_IDS, PoseGraphData, SE3Edges

_POSE_ID = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)


def _grow_rows(arr: np.ndarray, n: int, fill, new_cap: int) -> np.ndarray:
    """`arr` reallocated with `new_cap` rows (fill-padded), keeping its
    first `n` live rows: the one growth primitive behind every store."""
    out = np.empty((new_cap,) + arr.shape[1:], arr.dtype)
    out[...] = fill
    out[:n] = arr[:n]
    return out


def _upload(device: torch.device, arrays) -> list:
    """numpy arrays of one dtype (bool as int32) to the device in one copy
    -> tensors of their shapes (views of the copy)."""
    arrays = [np.asarray(x, np.int32) if x.dtype == bool else x
              for x in arrays]
    flat = torch.from_numpy(np.concatenate([x.ravel() for x in arrays]))
    flat = flat.to(device)
    out, o = [], 0
    for x in arrays:
        out.append(flat[o:o + x.size].view(x.shape))
        o += x.size
    return out


class _NpTable:
    """Capacity-sized numpy staging table with in-place row append; an
    add past the capacity doubles it."""

    def __init__(self, capacity: int,
                 fields: Dict[str, Tuple[tuple, np.dtype, object]]):
        self.n = 0
        self.capacity = capacity
        self._fields = fields
        self.arrays: Dict[str, np.ndarray] = {}
        for name, (shape, dtype, fill) in fields.items():
            arr = np.empty((capacity,) + shape, dtype)
            arr[...] = fill
            self.arrays[name] = arr

    def grow(self, new_cap: Optional[int] = None) -> None:
        new_cap = new_cap or max(1, self.capacity * 2)
        if new_cap <= self.capacity:
            return
        for name, (_, _, fill) in self._fields.items():
            self.arrays[name] = _grow_rows(self.arrays[name], self.n, fill,
                                           new_cap)
        self.capacity = new_cap

    def add(self, **values) -> int:
        if self.n >= self.capacity:
            self.grow()
        i = self.n
        for name, v in values.items():
            self.arrays[name][i] = v
        self.n += 1
        return i

    def __len__(self) -> int:
        return self.n

    def mask(self) -> np.ndarray:
        m = np.zeros(self.capacity, bool)
        m[: self.n] = True
        return m


class GraphSLAM:
    """Incremental pose-graph builder and optimizer front end, on one
    device (the card unless `device` says otherwise)."""

    def __init__(self, cfg: Optional[OptimizerConfig] = None,
                 capacity_nodes: int = 2048, capacity_edges: int = 8192,
                 device: DeviceLike = None):
        self.cfg = cfg or OptimizerConfig()
        self.device = resolve_device(device)
        self._n_nodes = 0
        self._poses = np.tile(_POSE_ID, (capacity_nodes, 1))
        self._node_fixed = np.zeros(capacity_nodes, bool)
        f32, i32 = np.float32, np.int32
        self._se3 = _NpTable(capacity_edges, {
            "from_idx": ((), i32, 0), "to_idx": ((), i32, 0),
            "meas": ((7,), f32, _POSE_ID), "info": ((6, 6), f32, 0.0),
            "kernel": ((), i32, 0), "delta": ((), f32, 1.0)})
        self.chi2_initial = 0.0
        self.chi2_final = 0.0
        self.last_iterations = 0
        # wall ms of the last optimize: the snapshot and the LM (which ends
        # on a host read), then the marginals and the packed read
        self.last_lm_ms = 0.0
        self.last_marginals_ms = 0.0
        # per-node 6x6 covariance blocks of the latest per-tick marginals
        self.last_marginals: Optional[np.ndarray] = None

    # -- views ----------------------------------------------------------
    @property
    def cap(self) -> Dict[str, int]:
        """Live store capacities (they double on overflow)."""
        return dict(nodes=self._poses.shape[0], edges=self._se3.capacity)

    @property
    def poses(self) -> np.ndarray:
        """(num_nodes, 7) current estimates (a view)."""
        return self._poses[: self._n_nodes]

    @property
    def fixed(self) -> np.ndarray:
        return self._node_fixed[: self._n_nodes]

    @property
    def num_nodes(self) -> int:
        return self._n_nodes

    @property
    def num_edges(self) -> int:
        return self._se3.n

    # -- nodes and edges -------------------------------------------------
    def add_se3_node(self, pose, fixed: bool = False) -> int:
        if self._n_nodes >= self._poses.shape[0]:
            new_cap = max(1, self._poses.shape[0] * 2)
            self._poses = _grow_rows(self._poses, self._n_nodes, _POSE_ID,
                                     new_cap)
            self._node_fixed = _grow_rows(self._node_fixed, self._n_nodes,
                                          False, new_cap)
        i = self._n_nodes
        self._poses[i] = np.asarray(pose, np.float32).reshape(7)
        self._node_fixed[i] = fixed
        self._n_nodes += 1
        return i

    def set_fixed(self, node_id: int, fixed: bool = True) -> None:
        self._node_fixed[node_id] = fixed

    def add_se3_edge(self, from_id: int, to_id: int, meas_pose, info,
                     kernel: str = "NONE", kernel_delta: float = 1.0) -> int:
        return self._se3.add(
            from_idx=from_id, to_idx=to_id,
            meas=np.asarray(meas_pose, np.float32).reshape(7),
            info=np.asarray(info, np.float32).reshape(6, 6),
            kernel=KERNEL_IDS[kernel], delta=float(kernel_delta))

    # -- solve ----------------------------------------------------------
    def snapshot(self) -> PoseGraphData:
        """The standing staging buffers as a PoseGraphData on the device,
        in two host-to-device copies (one per dtype)."""
        a = self._se3.arrays
        node_mask = np.zeros(self._poses.shape[0], bool)
        node_mask[: self._n_nodes] = True
        poses, meas, info, delta = _upload(
            self.device, [self._poses, a["meas"], a["info"], a["delta"]])
        from_idx, to_idx, kernel, flags, edge_mask = _upload(
            self.device, [a["from_idx"], a["to_idx"], a["kernel"],
                          np.stack([node_mask, self._node_fixed]),
                          self._se3.mask()])
        se3 = SE3Edges(from_idx=from_idx, to_idx=to_idx, meas=meas,
                       info=info, kernel=kernel, delta=delta,
                       mask=edge_mask.bool())
        return PoseGraphData.empty(0, 0, device=self.device)._replace(
            poses=poses, node_mask=flags[0].bool(),
            node_fixed=flags[1].bool(), se3=se3)

    def _live(self, g: PoseGraphData) -> PoseGraphData:
        """`g` cut to its live nodes and edges, which the staging buffers
        keep as prefixes. The padding adds nothing to a CG iteration's
        sums but zeros, so a solve on the live part gives the values of one
        at capacity."""
        n, ne = self._n_nodes, self._se3.n
        return g._replace(poses=g.poses[:n], node_mask=g.node_mask[:n],
                          node_fixed=g.node_fixed[:n],
                          se3=SE3Edges(*(a[:ne] for a in g.se3)))

    def optimize(self, num_iterations: Optional[int] = None) -> float:
        """Run LM; write the estimates back into the staging buffers.

        Returns the final chi2 and keeps chi2 before and after on the
        object (graph_slam.cpp:353-395). With cfg.chordal_init the LM
        starts from the chordal estimate. Unless cfg.per_tick_marginals
        is "none", the covariance blocks land in `self.last_marginals`
        (mrg_slam_component.cpp:882-891): "cg" marginals are the batched
        CG selected inverse of the live nodes, or the chain
        factorization's exact diagonal when the LM ran the chain
        backend. Poses, chi2 and marginals come back to the host in one
        packed read."""
        cfg = self.cfg
        if num_iterations is not None:
            cfg = dataclasses.replace(
                cfg, g2o_solver_num_iterations=num_iterations)
        t0 = time.perf_counter()
        g = self.snapshot()
        n = self._n_nodes
        if cfg.chordal_init and n:
            g = g._replace(poses=chordal_init(g))
        aux = None
        if solve.resolve_backend(cfg.solver_backend, g.n_nodes, g.n_planes,
                                 cfg.auto_dense_max_dofs) == "chain":
            # the coupling classification, off the host staging buffers
            a = self._se3.arrays
            aux = chain_solver.classify(a["from_idx"], a["to_idx"],
                                        self._se3.mask(), 0, 0)
        res = solve.optimize(g, cfg, aux=aux)
        t1 = time.perf_counter()
        mode = solve.resolve_marginals_mode(cfg.per_tick_marginals,
                                            self.cap["nodes"])
        if mode == "cg" and aux is not None:
            mode = "chain"
        parts = [res.poses.reshape(-1),
                 torch.stack([res.chi2_initial, res.chi2_final])]
        if mode != "none" and n:
            g_opt = g._replace(poses=res.poses)
            if mode == "chain":
                cov = chain_solver.chain_marginals(
                    g_opt, aux, solve._chain_K(g_opt.n_nodes))
            elif mode == "cg":
                cov = solve.marginals_selected(
                    self._live(g_opt),
                    torch.arange(n, device=self.device))
            else:
                cov = solve.marginals(g_opt, exact=(mode == "exact"))
            parts.append(cov.reshape(-1))
        flat = torch.cat(parts).cpu().numpy()
        npose = res.poses.numel()
        self._poses[:n] = flat[:npose].reshape(-1, 7)[:n]
        self.chi2_initial = float(flat[npose])
        self.chi2_final = float(flat[npose + 1])
        self.last_iterations = res.iterations
        if len(parts) == 3:
            self.last_marginals = flat[npose + 2:].reshape(-1, 6, 6)[:n]
        self.last_lm_ms = (t1 - t0) * 1e3
        self.last_marginals_ms = (time.perf_counter() - t1) * 1e3
        return self.chi2_final

    def compute_marginals(self, exact: bool = True) -> np.ndarray:
        """(num_nodes, 6, 6) covariance blocks at the current estimates
        (graph_slam.cpp:401-425): the dense inverse, or with exact=False
        the block-Jacobi approximation."""
        cov = solve.marginals(self.snapshot(), exact=exact)
        return cov[: self._n_nodes].cpu().numpy()
