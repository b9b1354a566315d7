"""Host-side graph construction: the `GraphSLAM` API surface.

Counterpart of the JAX package's graph/builder.py (include/mrg_slam/
graph_slam.hpp:34-174): an incremental builder over capacity-sized numpy
staging buffers, written in place at add time, that snapshot to the
device as a `PoseGraphData` for each solve. Stores double on overflow, so
a run never dies on a preallocation guess (the reference's g2o graph
grows without bound); a snapshot then carries the larger shape. Node and
edge ids are dense ints; uuid bookkeeping lives in
models/graph_database.py.

The prior and plane tables default to zero capacity here (the JAX
package's builder to 8 planes, 1024 priors, 2048 SE3-plane edges and 8
of each plane-plane kind), so a pose-only graph built directly pays
nothing for them; models/graph_database.py sizes them from the enabled
processors, as the JAX package's does, and every table doubles on
overflow. `optimize_many`, the batched solve of co-hosted robots'
graphs, waits for ROADMAP.md queue 1 item 14.
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
from .types import (KERNEL_IDS, PLANE_PLANE_IDENTITY, PLANE_PLANE_PARALLEL,
                    PLANE_PLANE_PERPENDICULAR, PLANE_PRIOR_DISTANCE,
                    PLANE_PRIOR_NORMAL, PRIOR_QUAT, PRIOR_VEC, PRIOR_XYZ,
                    PlaneEdges, PlanePlaneEdges, PlanePriorEdges,
                    PoseGraphData, PriorEdges, SE3Edges)

_POSE_ID = np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)
_PLANE_ID = np.asarray([0, 0, 1, 0], np.float32)


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
                 capacity_planes: int = 0, capacity_priors: int = 0,
                 capacity_plane_edges: int = 0,
                 capacity_plane_priors: int = 0,
                 capacity_plane_plane: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg or OptimizerConfig()
        self.device = resolve_device(device)
        self._n_nodes = 0
        self._poses = np.tile(_POSE_ID, (capacity_nodes, 1))
        self._node_fixed = np.zeros(capacity_nodes, bool)
        self._n_planes = 0
        self._planes = np.tile(_PLANE_ID, (capacity_planes, 1))
        self._plane_fixed = np.zeros(capacity_planes, bool)
        f32, i32 = np.float32, np.int32
        common = {"kernel": ((), i32, 0), "delta": ((), f32, 1.0)}
        self._se3 = _NpTable(capacity_edges, {
            "from_idx": ((), i32, 0), "to_idx": ((), i32, 0),
            "meas": ((7,), f32, _POSE_ID), "info": ((6, 6), f32, 0.0),
            **common})
        self._priors = _NpTable(capacity_priors, {
            "node_idx": ((), i32, 0), "ptype": ((), i32, 0),
            "meas": ((8,), f32, 0.0), "info": ((3, 3), f32, 0.0), **common})
        self._pl_edges = _NpTable(capacity_plane_edges, {
            "node_idx": ((), i32, 0), "plane_idx": ((), i32, 0),
            "meas": ((4,), f32, _PLANE_ID), "info": ((3, 3), f32, 0.0),
            **common})
        self._pl_priors = _NpTable(capacity_plane_priors, {
            "plane_idx": ((), i32, 0), "ptype": ((), i32, 0),
            "meas": ((4,), f32, 0.0), "info": ((4, 4), f32, 0.0), **common})
        self._pl_pl = _NpTable(capacity_plane_plane, {
            "from_idx": ((), i32, 0), "to_idx": ((), i32, 0),
            "ptype": ((), i32, 0), "meas": ((4,), f32, 0.0),
            "info": ((4, 4), f32, 0.0), **common})
        self.chi2_initial = 0.0
        self.chi2_final = 0.0
        self.last_iterations = 0
        # wall ms of the last optimize: the snapshot and the LM (which ends
        # on a host read), then the marginals and the packed read
        self.last_lm_ms = 0.0
        self.last_marginals_ms = 0.0
        # per-node 6x6 covariance blocks of the latest per-tick marginals
        self.last_marginals: Optional[np.ndarray] = None

    # the edge tables by PoseGraphData field, with their tuple types
    def _tables(self):
        return (("se3", SE3Edges, self._se3),
                ("priors", PriorEdges, self._priors),
                ("plane_edges", PlaneEdges, self._pl_edges),
                ("plane_priors", PlanePriorEdges, self._pl_priors),
                ("plane_plane", PlanePlaneEdges, self._pl_pl))

    # -- views ----------------------------------------------------------
    @property
    def cap(self) -> Dict[str, int]:
        """Live store capacities (they double on overflow)."""
        return dict(nodes=self._poses.shape[0], edges=self._se3.capacity,
                    planes=self._planes.shape[0],
                    priors=self._priors.capacity,
                    plane_edges=self._pl_edges.capacity,
                    plane_priors=self._pl_priors.capacity,
                    plane_plane=self._pl_pl.capacity)

    @property
    def poses(self) -> np.ndarray:
        """(num_nodes, 7) current estimates (a view)."""
        return self._poses[: self._n_nodes]

    @property
    def planes(self) -> np.ndarray:
        """(num_planes, 4) current plane estimates (a view)."""
        return self._planes[: self._n_planes]

    @property
    def fixed(self) -> np.ndarray:
        return self._node_fixed[: self._n_nodes]

    @property
    def num_nodes(self) -> int:
        return self._n_nodes

    @property
    def num_edges(self) -> int:
        return self._se3.n

    @property
    def num_plane_edges(self) -> int:
        return self._pl_edges.n

    # -- nodes ------------------------------------------------------------
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

    def add_plane_node(self, coeffs, fixed: bool = False) -> int:
        """A plane node (n, d), n.x + d = 0, its normal normalized."""
        if self._n_planes >= self._planes.shape[0]:
            new_cap = max(1, self._planes.shape[0] * 2)
            self._planes = _grow_rows(self._planes, self._n_planes,
                                      _PLANE_ID, new_cap)
            self._plane_fixed = _grow_rows(self._plane_fixed,
                                           self._n_planes, False, new_cap)
        c = np.asarray(coeffs, np.float32).reshape(4)
        c = c / max(np.linalg.norm(c[:3]), 1e-12)
        i = self._n_planes
        self._planes[i] = c
        self._plane_fixed[i] = fixed
        self._n_planes += 1
        return i

    def set_fixed(self, node_id: int, fixed: bool = True) -> None:
        self._node_fixed[node_id] = fixed

    # -- edges ------------------------------------------------------------
    def add_se3_edge(self, from_id: int, to_id: int, meas_pose, info,
                     kernel: str = "NONE", kernel_delta: float = 1.0) -> int:
        return self._se3.add(
            from_idx=from_id, to_idx=to_id,
            meas=np.asarray(meas_pose, np.float32).reshape(7),
            info=np.asarray(info, np.float32).reshape(6, 6),
            kernel=KERNEL_IDS[kernel], delta=float(kernel_delta))

    def _add_prior(self, node_id, ptype, meas8, info33, kernel, delta):
        return self._priors.add(
            node_idx=node_id, ptype=ptype, meas=meas8,
            info=np.asarray(info33, np.float32).reshape(3, 3),
            kernel=KERNEL_IDS[kernel], delta=float(delta))

    @staticmethod
    def _meas(n: int, *parts) -> np.ndarray:
        """A zero (n,) float32 measurement row with `parts` laid in
        from the front."""
        meas = np.zeros(n, np.float32)
        o = 0
        for p in parts:
            p = np.asarray(p, np.float32).reshape(-1)
            meas[o:o + p.size] = p
            o += p.size
        return meas

    def add_se3_prior_xyz_edge(self, node_id: int, xyz, info3,
                               kernel: str = "NONE",
                               kernel_delta: float = 1.0) -> int:
        return self._add_prior(node_id, PRIOR_XYZ, self._meas(8, xyz), info3,
                               kernel, kernel_delta)

    def add_se3_prior_xy_edge(self, node_id: int, xy, info2,
                              kernel: str = "NONE",
                              kernel_delta: float = 1.0) -> int:
        """The XY prior is the XYZ prior with zero information on z
        (include/g2o/edge_se3_priorxy.hpp)."""
        info = np.zeros((3, 3), np.float32)
        info[:2, :2] = np.asarray(info2, np.float32).reshape(2, 2)
        return self._add_prior(node_id, PRIOR_XYZ, self._meas(8, xy), info,
                               kernel, kernel_delta)

    def add_se3_prior_quat_edge(self, node_id: int, quat_wxyz, info3,
                                kernel: str = "NONE",
                                kernel_delta: float = 1.0) -> int:
        return self._add_prior(node_id, PRIOR_QUAT,
                               self._meas(8, quat_wxyz), info3, kernel,
                               kernel_delta)

    def add_se3_prior_vec_edge(self, node_id: int, dir_world, measured,
                               info3, kernel: str = "NONE",
                               kernel_delta: float = 1.0) -> int:
        return self._add_prior(node_id, PRIOR_VEC,
                               self._meas(8, dir_world, measured), info3,
                               kernel, kernel_delta)

    def add_se3_plane_edge(self, node_id: int, plane_id: int, plane_local,
                           info3, kernel: str = "NONE",
                           kernel_delta: float = 1.0) -> int:
        c = np.asarray(plane_local, np.float32).reshape(4)
        c = c / max(np.linalg.norm(c[:3]), 1e-12)
        return self._pl_edges.add(
            node_idx=node_id, plane_idx=plane_id, meas=c,
            info=np.asarray(info3, np.float32).reshape(3, 3),
            kernel=KERNEL_IDS[kernel], delta=float(kernel_delta))

    @staticmethod
    def _info4(info, k: int) -> np.ndarray:
        """A (k, k) information padded to the 4-dim residual."""
        out = np.zeros((4, 4), np.float32)
        out[:k, :k] = np.asarray(info, np.float32).reshape(k, k)
        return out

    def add_plane_prior_normal_edge(self, plane_id: int, normal, info3,
                                    kernel: str = "NONE",
                                    kernel_delta: float = 1.0) -> int:
        return self._pl_priors.add(
            plane_idx=plane_id, ptype=PLANE_PRIOR_NORMAL,
            meas=self._meas(4, normal), info=self._info4(info3, 3),
            kernel=KERNEL_IDS[kernel], delta=float(kernel_delta))

    def add_plane_prior_distance_edge(self, plane_id: int, distance: float,
                                      info1: float, kernel: str = "NONE",
                                      kernel_delta: float = 1.0) -> int:
        return self._pl_priors.add(
            plane_idx=plane_id, ptype=PLANE_PRIOR_DISTANCE,
            meas=self._meas(4, distance), info=self._info4(info1, 1),
            kernel=KERNEL_IDS[kernel], delta=float(kernel_delta))

    def _add_plane_plane(self, a, b, ptype, meas4, info44, kernel, delta):
        return self._pl_pl.add(
            from_idx=a, to_idx=b, ptype=ptype, meas=meas4, info=info44,
            kernel=KERNEL_IDS[kernel], delta=float(delta))

    def add_plane_identity_edge(self, a: int, b: int, meas4, info4,
                                kernel: str = "NONE",
                                kernel_delta: float = 1.0) -> int:
        return self._add_plane_plane(a, b, PLANE_PLANE_IDENTITY,
                                     self._meas(4, meas4),
                                     self._info4(info4, 4), kernel,
                                     kernel_delta)

    def add_plane_parallel_edge(self, a: int, b: int, meas3, info3,
                                kernel: str = "NONE",
                                kernel_delta: float = 1.0) -> int:
        return self._add_plane_plane(a, b, PLANE_PLANE_PARALLEL,
                                     self._meas(4, meas3),
                                     self._info4(info3, 3), kernel,
                                     kernel_delta)

    def add_plane_perpendicular_edge(self, a: int, b: int,
                                     meas_dot: float = 0.0,
                                     info1: float = 1.0,
                                     kernel: str = "NONE",
                                     kernel_delta: float = 1.0) -> int:
        return self._add_plane_plane(a, b, PLANE_PLANE_PERPENDICULAR,
                                     self._meas(4, meas_dot),
                                     self._info4(info1, 1), kernel,
                                     kernel_delta)

    # -- solve ----------------------------------------------------------
    def snapshot(self) -> PoseGraphData:
        """The standing staging buffers as a PoseGraphData on the device,
        in two host-to-device copies (one per dtype)."""
        node_mask = np.zeros(self._poses.shape[0], bool)
        node_mask[: self._n_nodes] = True
        plane_mask = np.zeros(self._planes.shape[0], bool)
        plane_mask[: self._n_planes] = True
        tables = [(name, cls, t) for name, cls, t in self._tables()]
        fkeys = [[k for k, a in t.arrays.items() if a.dtype == np.float32]
                 for _, _, t in tables]
        ikeys = [[k for k, a in t.arrays.items() if a.dtype != np.float32]
                 for _, _, t in tables]
        floats = _upload(self.device, [self._poses, self._planes] + [
            t.arrays[k] for (_, _, t), ks in zip(tables, fkeys) for k in ks])
        ints = _upload(self.device, [
            np.stack([node_mask, self._node_fixed]),
            np.stack([plane_mask, self._plane_fixed])] + [
            x for (_, _, t), ks in zip(tables, ikeys)
            for x in [t.arrays[k] for k in ks] + [t.mask()]])
        poses, planes = floats[:2]
        nflags, pflags = ints[:2]
        fo, io = 2, 2
        out = {}
        for (name, cls, _), fk, ik in zip(tables, fkeys, ikeys):
            fields = dict(zip(fk, floats[fo:fo + len(fk)]))
            fields.update(zip(ik, ints[io:io + len(ik)]))
            fields["mask"] = ints[io + len(ik)].bool()
            fo += len(fk)
            io += len(ik) + 1
            out[name] = cls(**fields)
        return PoseGraphData(
            poses=poses, node_mask=nflags[0].bool(),
            node_fixed=nflags[1].bool(), planes=planes,
            plane_mask=pflags[0].bool(), plane_fixed=pflags[1].bool(),
            **out)

    def _live(self, g: PoseGraphData) -> PoseGraphData:
        """`g` cut to its live nodes, planes and edges, which the staging
        buffers keep as prefixes. The padding adds nothing to a CG
        iteration's sums but zeros, so a solve on the live part gives the
        values of one at capacity. A table of zero capacity stays so."""
        n, p = self._n_nodes, self._n_planes
        tabs = {name: type(getattr(g, name))(
            *(a[:t.n] for a in getattr(g, name)))
            for name, _, t in self._tables()}
        return g._replace(poses=g.poses[:n], node_mask=g.node_mask[:n],
                          node_fixed=g.node_fixed[:n], planes=g.planes[:p],
                          plane_mask=g.plane_mask[:p],
                          plane_fixed=g.plane_fixed[:p], **tabs)

    def _chain_aux(self) -> chain_solver.ChainAux:
        """The chain backend's coupling classification, off the host
        staging buffers."""
        a = self._se3.arrays
        return chain_solver.classify(
            a["from_idx"], a["to_idx"], self._se3.mask(),
            self._pl_edges.capacity, self._pl_pl.capacity,
            pl_mask=self._pl_edges.mask(), qq_mask=self._pl_pl.mask())

    def optimize(self, num_iterations: Optional[int] = None) -> float:
        """Run LM; write the estimates back into the staging buffers.

        Returns the final chi2 and keeps chi2 before and after on the
        object (graph_slam.cpp:353-395). With cfg.chordal_init the LM
        starts from the chordal estimate. Unless cfg.per_tick_marginals
        is "none", the covariance blocks land in `self.last_marginals`
        (mrg_slam_component.cpp:882-891): "cg" marginals are the batched
        CG selected inverse of the live nodes, or the chain
        factorization's exact diagonal when the LM ran the chain
        backend. Poses, planes, chi2 and marginals come back to the host
        in one packed read."""
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
            aux = self._chain_aux()
        res = solve.optimize(g, cfg, aux=aux)
        t1 = time.perf_counter()
        mode = solve.resolve_marginals_mode(cfg.per_tick_marginals,
                                            self.cap["nodes"],
                                            self.cap["planes"])
        if mode == "cg" and aux is not None:
            mode = "chain"
        p = self._n_planes
        parts = [res.poses.reshape(-1), res.planes.reshape(-1),
                 torch.stack([res.chi2_initial, res.chi2_final])]
        if mode != "none" and n:
            g_opt = g._replace(poses=res.poses, planes=res.planes)
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
        npose, nplane = res.poses.numel(), res.planes.numel()
        self._poses[:n] = flat[:npose].reshape(-1, 7)[:n]
        self._planes[:p] = flat[npose:npose + nplane].reshape(-1, 4)[:p]
        o = npose + nplane
        self.chi2_initial = float(flat[o])
        self.chi2_final = float(flat[o + 1])
        self.last_iterations = res.iterations
        if len(parts) == 4:
            self.last_marginals = flat[o + 2:].reshape(-1, 6, 6)[:n]
        self.last_lm_ms = (t1 - t0) * 1e3
        self.last_marginals_ms = (time.perf_counter() - t1) * 1e3
        return self.chi2_final

    def compute_marginals(self, exact: bool = True) -> np.ndarray:
        """(num_nodes, 6, 6) covariance blocks at the current estimates
        (graph_slam.cpp:401-425): the dense inverse, or with exact=False
        the block-Jacobi approximation."""
        cov = solve.marginals(self.snapshot(), exact=exact)
        return cov[: self._n_nodes].cpu().numpy()
