"""Graph visualization export: the MarkersPublisher without RViz.

Counterpart of the JAX package's models/markers.py.
src/mrg_slam/markers_publisher.cpp renders node spheres, odometry and
loop edges, text labels and 3-sigma covariance ellipsoids as RViz
MarkerArrays; here the same content goes to portable artifacts:

- `graph_summary`: a JSON-able dict of nodes, edges by type, labels, the
  loop-search radius circle and, with marginals, each node's 3-sigma
  ellipsoid axes from the eigendecomposition of its covariance
  (:360, 447-533). The covariances are the last tick's per-tick
  marginals, or an exact pass of the port's solver when there are none.
- `export_ply`: a coloured PLY point and line soup for MeshLab or
  CloudCompare.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .backend import MrgSlam

_COLORS = {
    "node": (64, 128, 255),
    "odom": (230, 230, 230),
    "loop": (255, 64, 64),
    "anchor": (255, 200, 0),
}


def covariance_ellipsoids(cov_blocks: np.ndarray,
                          n_sigma: float = 3.0) -> List[Dict]:
    """Per node, an ellipsoid {axes (3,), rotation (3, 3)} from the
    translation block of its 6x6 covariance (markers_publisher.cpp:360)."""
    out = []
    for cov in cov_blocks:
        c3 = cov[:3, :3]
        w, v = np.linalg.eigh((c3 + c3.T) / 2)
        w = np.maximum(w, 0.0)
        out.append({"axes": (n_sigma * np.sqrt(w)).tolist(),
                    "rotation": v.tolist()})
    return out


def graph_summary(slam: MrgSlam, with_marginals: bool = False,
                  loop_radius: Optional[float] = None) -> Dict:
    db = slam.db
    kfs = [k for k in db.keyframes + db.new_keyframes
           if k.node_id is not None]
    uuid_to_pos = {}
    nodes = []
    for k in kfs:
        est = k.estimate(db.graph)
        uuid_to_pos[k.uuid] = est[:3].tolist()
        nodes.append({"uuid": k.uuid, "label": k.readable_id,
                      "robot": k.robot_name, "pose": est.tolist(),
                      "first": k.first_keyframe, "static": k.static_keyframe})
    edges = []
    for e in db.edges:
        a = uuid_to_pos.get(e.from_uuid)
        b = uuid_to_pos.get(e.to_uuid)
        if a is None or b is None:
            continue
        edges.append({"type": e.type, "from": a, "to": b,
                      "readable": e.readable_id})
    summary: Dict = {"robot": slam.own_name, "nodes": nodes, "edges": edges}
    if loop_radius is None:
        loop_radius = slam.cfg.loop.candidate_max_xy_distance
    prev = db.prev_robot_keyframe
    if prev is not None and prev.node_id is not None:
        summary["loop_radius_circle"] = {
            "center": prev.estimate(db.graph)[:3].tolist(),
            "radius": loop_radius}
    if with_marginals and kfs:
        # the covariances of the last optimization tick
        # (mrg_slam_component.cpp:882-891 attaches marginals to every
        # KeyFrameSnapshot), else an exact pass now
        cov = db.graph.last_marginals
        if cov is None:
            cov = db.graph.compute_marginals(exact=True)
        summary["ellipsoids"] = covariance_ellipsoids(
            cov[[k.node_id for k in kfs]])
    return summary


def export_ply(slam: MrgSlam, path, edge_segments: int = 8) -> None:
    """A coloured binary PLY: node points and edge polylines sampled as
    points."""
    summary = graph_summary(slam)
    pts: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    for n in summary["nodes"]:
        pts.append(np.asarray(n["pose"][:3]))
        cols.append(np.asarray(_COLORS["node"]))
    for e in summary["edges"]:
        a, b = np.asarray(e["from"]), np.asarray(e["to"])
        ts = np.linspace(0, 1, edge_segments)[:, None]
        pts.extend(a[None, :] * (1 - ts) + b[None, :] * ts)
        cols.extend([np.asarray(_COLORS.get(e["type"], (200, 200, 200)))]
                    * edge_segments)
    pts_a = np.stack(pts) if pts else np.zeros((0, 3))
    cols_a = np.stack(cols) if cols else np.zeros((0, 3))
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(pts_a)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\n"
                 "property uchar blue\nend_header\n").encode())
        rec = np.zeros(len(pts_a), dtype=[("xyz", np.float32, 3),
                                          ("rgb", np.uint8, 3)])
        rec["xyz"] = pts_a.astype(np.float32)
        rec["rgb"] = cols_a.astype(np.uint8)
        f.write(rec.tobytes())
