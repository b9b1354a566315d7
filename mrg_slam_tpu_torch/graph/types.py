"""Pose-graph data layout: fixed-capacity typed edge tables, in torch.

Counterpart of the JAX package's graph/types.py, with the same fields,
kernel ids and padding. Node state is a pool of SE(3) poses (6 dof) and a
pool of planes (3 dof); each edge family has its own masked table:

- SE3-SE3 edges: odometry / loop / anchor (g2o EdgeSE3);
- unary SE3 priors: XYZ (XY is XYZ with zero z information), quaternion
  and vector (include/g2o/edge_se3_priorxyz.hpp etc.);
- SE3-plane edges: floor constraints (include/g2o/edge_se3_plane.hpp);
- plane priors (normal, distance) and plane-plane edges (identity,
  parallel, perpendicular), which the reference registers but its live
  pipeline does not create.

A table of zero capacity costs a solve nothing (graph/solve.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# prior edge types
PRIOR_XYZ = 0
PRIOR_QUAT = 1
PRIOR_VEC = 2

# plane-prior edge types (include/g2o/edge_plane_prior.hpp)
PLANE_PRIOR_NORMAL = 0
PLANE_PRIOR_DISTANCE = 1

# plane-plane edge types (include/g2o/edge_plane_identity.hpp, _parallel.hpp)
PLANE_PLANE_IDENTITY = 0
PLANE_PLANE_PARALLEL = 1
PLANE_PLANE_PERPENDICULAR = 2

# robust kernel ids (graph/robust.py implements their rho and weights)
KERNEL_NONE = 0
KERNEL_HUBER = 1
KERNEL_CAUCHY = 2
KERNEL_DCS = 3
KERNEL_FAIR = 4
KERNEL_GEMAN_MCCLURE = 5
KERNEL_PSEUDO_HUBER = 6
KERNEL_SATURATED = 7
KERNEL_TUKEY = 8
KERNEL_WELSCH = 9

KERNEL_IDS = {
    "NONE": KERNEL_NONE,
    "Huber": KERNEL_HUBER,
    "Cauchy": KERNEL_CAUCHY,
    "DCS": KERNEL_DCS,
    "Fair": KERNEL_FAIR,
    "GemanMcClure": KERNEL_GEMAN_MCCLURE,
    "PseudoHuber": KERNEL_PSEUDO_HUBER,
    "Saturated": KERNEL_SATURATED,
    "Tukey": KERNEL_TUKEY,
    "Welsch": KERNEL_WELSCH,
}

POSE_IDENTITY = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)
PLANE_IDENTITY = (0.0, 0.0, 1.0, 0.0)


def _rows(capacity: int, row, device) -> torch.Tensor:
    """(capacity, len(row)) copies of `row`, made by fills on the device
    (no host-to-device copy, which would sync the stream)."""
    out = torch.zeros(capacity, len(row), device=device)
    for k, v in enumerate(row):
        if v:
            out[:, k] = v
    return out


def _common(capacity: int, device) -> dict:
    return dict(kernel=torch.zeros(capacity, dtype=torch.int32,
                                   device=device),
                delta=torch.ones(capacity, device=device),
                mask=torch.zeros(capacity, dtype=torch.bool, device=device))


def _idx(capacity: int, device) -> torch.Tensor:
    return torch.zeros(capacity, dtype=torch.int32, device=device)


class SE3Edges(NamedTuple):
    from_idx: torch.Tensor  # (E,) int32
    to_idx: torch.Tensor    # (E,) int32
    meas: torch.Tensor      # (E, 7) measured relative pose T_from^-1 T_to
    info: torch.Tensor      # (E, 6, 6) information (rho-first twist order)
    kernel: torch.Tensor    # (E,) int32 robust kernel id
    delta: torch.Tensor     # (E,) robust kernel width
    mask: torch.Tensor      # (E,) bool

    @staticmethod
    def empty(capacity: int, device=None) -> "SE3Edges":
        return SE3Edges(from_idx=_idx(capacity, device),
                        to_idx=_idx(capacity, device),
                        meas=_rows(capacity, POSE_IDENTITY, device),
                        info=torch.zeros(capacity, 6, 6, device=device),
                        **_common(capacity, device))


class PriorEdges(NamedTuple):
    node_idx: torch.Tensor  # (E,) int32
    ptype: torch.Tensor     # (E,) int32 prior type (XYZ, quat, vector)
    meas: torch.Tensor      # (E, 8)
    info: torch.Tensor      # (E, 3, 3)
    kernel: torch.Tensor
    delta: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def empty(capacity: int, device=None) -> "PriorEdges":
        return PriorEdges(node_idx=_idx(capacity, device),
                          ptype=_idx(capacity, device),
                          meas=torch.zeros(capacity, 8, device=device),
                          info=torch.zeros(capacity, 3, 3, device=device),
                          **_common(capacity, device))


class PlaneEdges(NamedTuple):
    node_idx: torch.Tensor   # (E,) int32 SE3 node
    plane_idx: torch.Tensor  # (E,) int32 plane node
    meas: torch.Tensor       # (E, 4) local plane (nx, ny, nz, d)
    info: torch.Tensor       # (E, 3, 3)
    kernel: torch.Tensor
    delta: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def empty(capacity: int, device=None) -> "PlaneEdges":
        return PlaneEdges(node_idx=_idx(capacity, device),
                          plane_idx=_idx(capacity, device),
                          meas=_rows(capacity, PLANE_IDENTITY, device),
                          info=torch.zeros(capacity, 3, 3, device=device),
                          **_common(capacity, device))


class PlanePriorEdges(NamedTuple):
    plane_idx: torch.Tensor  # (E,) int32
    ptype: torch.Tensor      # (E,) int32
    meas: torch.Tensor       # (E, 4)
    info: torch.Tensor       # (E, 4, 4)
    kernel: torch.Tensor
    delta: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def empty(capacity: int, device=None) -> "PlanePriorEdges":
        return PlanePriorEdges(plane_idx=_idx(capacity, device),
                               ptype=_idx(capacity, device),
                               meas=torch.zeros(capacity, 4, device=device),
                               info=torch.zeros(capacity, 4, 4,
                                                device=device),
                               **_common(capacity, device))


class PlanePlaneEdges(NamedTuple):
    from_idx: torch.Tensor  # (E,) int32 plane node
    to_idx: torch.Tensor    # (E,) int32 plane node
    ptype: torch.Tensor     # (E,) int32
    meas: torch.Tensor      # (E, 4)
    info: torch.Tensor      # (E, 4, 4)
    kernel: torch.Tensor
    delta: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def empty(capacity: int, device=None) -> "PlanePlaneEdges":
        return PlanePlaneEdges(from_idx=_idx(capacity, device),
                               to_idx=_idx(capacity, device),
                               ptype=_idx(capacity, device),
                               meas=torch.zeros(capacity, 4, device=device),
                               info=torch.zeros(capacity, 4, 4,
                                                device=device),
                               **_common(capacity, device))


# the edge tables of a graph, by PoseGraphData field
EDGE_TABLES = dict(se3=SE3Edges, priors=PriorEdges, plane_edges=PlaneEdges,
                   plane_priors=PlanePriorEdges, plane_plane=PlanePlaneEdges)


class PoseGraphData(NamedTuple):
    """The whole graph state of one solve, on one device."""

    poses: torch.Tensor        # (N, 7)
    node_mask: torch.Tensor    # (N,) bool
    node_fixed: torch.Tensor   # (N,) bool
    planes: torch.Tensor       # (P, 4)
    plane_mask: torch.Tensor   # (P,) bool
    plane_fixed: torch.Tensor  # (P,) bool
    se3: SE3Edges
    priors: PriorEdges
    plane_edges: PlaneEdges
    plane_priors: PlanePriorEdges
    plane_plane: PlanePlaneEdges

    @staticmethod
    def empty(n_nodes: int, n_edges: int, n_planes: int = 0,
              n_priors: int = 0, n_plane_edges: int = 0,
              n_plane_priors: int = 0, n_plane_plane: int = 0,
              device=None) -> "PoseGraphData":
        def flags(n):
            return torch.zeros(n, dtype=torch.bool, device=device)

        return PoseGraphData(
            poses=_rows(n_nodes, POSE_IDENTITY, device),
            node_mask=flags(n_nodes), node_fixed=flags(n_nodes),
            planes=_rows(n_planes, PLANE_IDENTITY, device),
            plane_mask=flags(n_planes), plane_fixed=flags(n_planes),
            se3=SE3Edges.empty(n_edges, device),
            priors=PriorEdges.empty(n_priors, device),
            plane_edges=PlaneEdges.empty(n_plane_edges, device),
            plane_priors=PlanePriorEdges.empty(n_plane_priors, device),
            plane_plane=PlanePlaneEdges.empty(n_plane_plane, device))

    @property
    def n_nodes(self) -> int:
        return self.poses.shape[0]

    @property
    def n_planes(self) -> int:
        return self.planes.shape[0]


def plane_basis(n: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit normals -> (..., 3, 2) tangent bases [b1, b2]: b1 = n x
    ref normalized, with ref the x axis where |n_x| < 0.9 and the y axis
    elsewhere, and b2 = n x b1."""
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(n)
    ey[..., 1] = 1.0
    ref = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    b1 = torch.linalg.cross(n, ref, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1, keepdim=True),
                          min=1e-12)
    b2 = torch.linalg.cross(n, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def plane_retract(pi: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The 3-dof plane chart: the normal moves by B(n) delta[:2] in its
    tangent plane and is renormalized, d shifts by delta[2]."""
    n = pi[..., 0:3]
    n_new = n + (plane_basis(n) @ delta[..., 0:2, None])[..., 0]
    n_new = n_new / torch.clamp(
        torch.linalg.vector_norm(n_new, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([n_new, pi[..., 3:4] + delta[..., 2:3]], dim=-1)
