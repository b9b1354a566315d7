"""Graph persistence: save_graph / load_graph (checkpoint and resume) and
the .g2o import.

Counterpart of the JAX package's models/persistence.py, with the
reference's directory layout (save_graph_service,
mrg_slam_component.cpp:930-1045; KeyFrame::save keyframe.cpp:53-110;
Edge::save edge.cpp:53-120; GraphSLAM::save graph_slam.cpp:428):

    <dir>/keyframes/NNNNNN/data.txt + cloud.pcd
    <dir>/edges/NNNNNN/data.txt
    <dir>/graph.g2o              (VERTEX_SE3:QUAT / EDGE_SE3:QUAT interop)
    <dir>/graph.g2o.kernels      (robust kernels by vertex pair)
    <dir>/special_nodes.csv      (anchor and floor bookkeeping)
    <dir>/network_stats.txt, timing_stats.txt [, zero_utm.txt]

A directory either package writes, the other loads, and a save -> load ->
save repeats `keyframes/` and `edges/` byte for byte. Loading merges
keyframes and edges by uuid into a running store on its next tick
(load_graph -> GraphDatabase.flush_loaded_graph, graph_database.cpp:
393-568), so a saved graph joins a new session as another chain.

The keyframe clouds live on the store's device: a save reads them all off
it in one packed read, and a load puts them on it in one upload.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..graph.builder import GraphSLAM
from ..io.pcd import load_pcd, save_pcd
from ..ops.cloud import PAD_VALUE, PointCloud
from ..runtime import DeviceLike
from .backend import MrgSlam
from .keyframe import Edge, KeyFrame


def _fmt_pose(p: np.ndarray) -> str:
    return " ".join(f"{v:.9f}" for v in np.asarray(p).reshape(-1))


def _cloud_arrays(kfs: List[KeyFrame]) -> List[np.ndarray]:
    """Each keyframe's valid points, (n, 3) float32, from one packed read
    of every cloud (points and mask side by side)."""
    if not kfs:
        return []
    packed = torch.cat([torch.cat([k.cloud.points.reshape(-1, 3),
                                   k.cloud.mask.reshape(-1, 1).to(
                                       k.cloud.points.dtype)], 1)
                        for k in kfs]).cpu().numpy()
    out, o = [], 0
    for k in kfs:
        block = packed[o:o + k.cloud.capacity]
        o += k.cloud.capacity
        out.append(np.ascontiguousarray(block[block[:, 3] > 0, :3]))
    return out


def save_graph(slam: MrgSlam, directory) -> int:
    """Write the whole graph; returns the number of keyframes written."""
    d = Path(directory)
    (d / "keyframes").mkdir(parents=True, exist_ok=True)
    (d / "edges").mkdir(parents=True, exist_ok=True)
    db = slam.db

    kfs = [k for k in db.keyframes + db.new_keyframes
           if k.node_id is not None]
    for i, (kf, pts) in enumerate(zip(kfs, _cloud_arrays(kfs))):
        kdir = d / "keyframes" / f"{i:06d}"
        kdir.mkdir(exist_ok=True)
        est = kf.estimate(db.graph)
        with open(kdir / "data.txt", "w") as f:
            f.write(f"robot_name {kf.robot_name}\n"
                    f"uuid_str {kf.uuid}\n"
                    f"slam_uuid_str {kf.slam_uuid}\n"
                    f"stamp {kf.stamp:.9f}\n"
                    f"odom_counter {kf.odom_counter}\n"
                    f"first_keyframe {int(kf.first_keyframe)}\n"
                    f"static_keyframe {int(kf.static_keyframe)}\n"
                    f"accum_distance {kf.accum_distance:.9f}\n"
                    f"estimate {_fmt_pose(est)}\n"
                    f"odom {_fmt_pose(kf.odom)}\n")
            # the optional sensor attachments (keyframe.cpp:88-104)
            for key in ("floor_coeffs", "utm_coord", "acceleration",
                        "orientation"):
                val = getattr(kf, key)
                if val is not None:
                    f.write(f"{key} {_fmt_pose(val)}\n")
        save_pcd(kdir / "cloud.pcd", pts)

    for i, e in enumerate(db.edges):
        edir = d / "edges" / f"{i:06d}"
        edir.mkdir(exist_ok=True)
        with open(edir / "data.txt", "w") as f:
            f.write(f"type {e.type}\n"
                    f"uuid_str {e.uuid}\n"
                    f"from_uuid_str {e.from_uuid}\n"
                    f"to_uuid_str {e.to_uuid}\n"
                    f"relative_pose {_fmt_pose(e.relative_pose)}\n"
                    f"information {_fmt_pose(e.information)}\n"
                    f"robust_kernel {e.robust_kernel}\n"
                    f"robust_kernel_size {e.robust_kernel_size:.9f}\n")

    _save_g2o(db, d / "graph.g2o")
    # the robust kernels' sidecar (robust_kernel_io.cpp): kernel name and
    # delta of each edge, by its vertex ids
    uuid_to_node = {k.uuid: k.node_id for k in kfs}
    with open(d / "graph.g2o.kernels", "w") as f:
        for e in db.edges:
            if e.robust_kernel == "NONE":
                continue
            a = uuid_to_node.get(e.from_uuid)
            b = uuid_to_node.get(e.to_uuid)
            if a is None or b is None:
                continue
            f.write(f"{a} {b} {e.robust_kernel} {e.robust_kernel_size}\n")

    with open(d / "special_nodes.csv", "w") as f:
        anchor_node = db.anchor_kf.node_id if db.anchor_kf else -1
        anchor_edge = (db.anchor_edge.edge_id
                       if db.anchor_edge is not None else -1)
        floor_node = slam.floor_processor.plane_node_id
        f.write(f"anchor_node,{anchor_node}\n"
                f"anchor_edge,{anchor_edge}\n"
                f"floor_node,{-1 if floor_node is None else floor_node}\n")

    zero_utm = slam.gps_processor.zero_utm
    if zero_utm is not None:
        np.savetxt(d / "zero_utm.txt", zero_utm[None])

    with open(d / "network_stats.txt", "w") as f:
        f.write(f"sent_graph_bytes {sum(slam.sent_graph_bytes)}\n"
                f"received_graph_bytes {sum(slam.received_graph_bytes)}\n")
    with open(d / "timing_stats.txt", "w") as f:
        lds = slam.loop_detector.loop_detection_times
        f.write(f"num_ticks {len(slam.tick_stats)}\n"
                f"loop_detection_count {len(lds)}\n")
        if lds:
            f.write(f"loop_detection_avg_us {np.mean(lds):.1f}\n")
        if slam.tick_stats:
            avg = np.mean([t.optimization_us for t in slam.tick_stats])
            f.write(f"optimization_avg_us {avg:.1f}\n")
    return len(kfs)


def _save_g2o(db, path) -> None:
    """The g2o text format, for the reference's tooling
    (g2o_to_pose_file.py reads the VERTEX_SE3:QUAT lines); g2o stores
    quaternions xyzw, the poses here wxyz."""
    anchor = [db.anchor_kf] if db.anchor_kf else []
    kfs = [k for k in anchor + db.keyframes + db.new_keyframes
           if k.node_id is not None]
    with open(path, "w") as f:
        for kf in sorted(kfs, key=lambda k: k.node_id):
            p = kf.estimate(db.graph)
            f.write(f"VERTEX_SE3:QUAT {kf.node_id} "
                    f"{p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{p[4]:.9f} {p[5]:.9f} {p[6]:.9f} {p[3]:.9f}\n")
            if kf is db.anchor_kf:
                f.write(f"FIX {kf.node_id}\n")
        uuid_to_node = {k.uuid: k.node_id for k in kfs}
        for e in db.edges:
            a = uuid_to_node.get(e.from_uuid)
            b = uuid_to_node.get(e.to_uuid)
            if a is None or b is None:
                continue
            p = e.relative_pose
            upper = np.asarray(e.information)[np.triu_indices(6)]
            f.write(f"EDGE_SE3:QUAT {a} {b} "
                    f"{p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                    f"{p[4]:.9f} {p[5]:.9f} {p[6]:.9f} {p[3]:.9f} "
                    + " ".join(f"{v:.9f}" for v in upper) + "\n")


def _vec(text: str) -> np.ndarray:
    return np.asarray([float(v) for v in text.split()], np.float32)


def _meta(path: Path) -> Dict[str, str]:
    out = {}
    for line in path.read_text().splitlines():
        key, _, val = line.partition(" ")
        out[key] = val
    return out


def load_graph(slam: MrgSlam, directory,
               cloud_capacity: Optional[int] = None) -> int:
    """Read a saved graph and queue it for the uuid merge of the next
    optimization tick (load_graph_service -> flush_loaded_graph,
    graph_database.cpp:393-568).

    Keyframes whose uuid the store holds already are skipped, and so are
    known edges. Restored with them: the sensor attachments (floor, UTM,
    IMU), each edge's robust kernel, the anchor edge (re-attached to this
    store's anchor at the flush) and static keyframes (fixed there). The
    clouds, cut to `cloud_capacity` points (default: the config's
    `capacity_keyframe_points`), go onto the store's device in one
    upload. Returns the number of keyframes queued.
    """
    d = Path(directory)
    db = slam.db
    cap = cloud_capacity or slam.cfg.capacity_keyframe_points
    metas, clouds = [], []
    for kdir in sorted((d / "keyframes").iterdir()):
        meta = _meta(kdir / "data.txt")
        if meta["uuid_str"] in db.uuid_keyframe_map:
            continue  # uuid dedup (graph_database.cpp:456-459)
        metas.append(meta)
        clouds.append(load_pcd(kdir / "cloud.pcd"))
    pts = np.full((len(metas), cap, 3), PAD_VALUE, np.float32)
    mask = np.zeros((len(metas), cap), bool)
    for i, c in enumerate(clouds):
        n = min(len(c), cap)
        pts[i, :n] = c[:n]
        mask[i, :n] = True
    dev = db.graph.device
    pts_d = torch.from_numpy(pts).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    kfs: List[KeyFrame] = []
    for i, meta in enumerate(metas):
        kf = KeyFrame(
            robot_name=meta["robot_name"], stamp=float(meta["stamp"]),
            odom=_vec(meta["odom"]),
            accum_distance=float(meta["accum_distance"]),
            cloud=PointCloud(pts_d[i], mask_d[i]),
            uuid=meta["uuid_str"], slam_uuid=meta["slam_uuid_str"],
            odom_counter=int(meta["odom_counter"]),
            first_keyframe=bool(int(meta["first_keyframe"])),
            static_keyframe=bool(int(meta["static_keyframe"])))
        kf.estimate_loaded = _vec(meta["estimate"])
        for key in ("floor_coeffs", "utm_coord", "acceleration",
                    "orientation"):
            if key in meta:
                setattr(kf, key, _vec(meta[key]))
        kfs.append(kf)
    edges: List[Edge] = []
    edges_dir = d / "edges"
    if edges_dir.exists():
        for edir in sorted(edges_dir.iterdir()):
            meta = _meta(edir / "data.txt")
            if meta["uuid_str"] in db.edge_uuids:
                continue
            edges.append(Edge(
                type=meta["type"], uuid=meta["uuid_str"],
                from_uuid=meta["from_uuid_str"],
                to_uuid=meta["to_uuid_str"],
                relative_pose=_vec(meta["relative_pose"]),
                information=_vec(meta["information"]).reshape(6, 6),
                robust_kernel=meta.get("robust_kernel", "NONE"),
                robust_kernel_size=float(
                    meta.get("robust_kernel_size", 1.0))))
    if kfs or edges:
        db.add_loaded_graph(kfs, edges)
    return len(kfs)


def load_g2o(path, kernels_path=None, device: DeviceLike = None
             ) -> GraphSLAM:
    """Import a bare .g2o file (and optionally its robust-kernel sidecar)
    into a fresh GraphSLAM builder on `device` (the card unless it says
    otherwise): GraphSLAM::load interop (graph_slam.cpp:445-457,
    robust_kernel_io.cpp:44-151).

    Reads VERTEX_SE3:QUAT, EDGE_SE3:QUAT and FIX lines (quaternions xyzw
    in the file, wxyz in the builder). A sidecar row is `from_id to_id
    kernel_name delta`, matched by the edge's vertex ids.
    """
    vertices, edges, fixed = {}, [], set()
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "VERTEX_SE3:QUAT":
            x, y, z, qx, qy, qz, qw = (float(v) for v in parts[2:9])
            vertices[int(parts[1])] = np.asarray([x, y, z, qw, qx, qy, qz],
                                                 np.float32)
        elif parts[0] == "FIX":
            fixed.add(int(parts[1]))
        elif parts[0] == "EDGE_SE3:QUAT":
            x, y, z, qx, qy, qz, qw = (float(v) for v in parts[3:10])
            info = np.zeros((6, 6), np.float32)
            info[np.triu_indices(6)] = [float(v) for v in parts[10:31]]
            info = info + np.triu(info, 1).T
            edges.append((int(parts[1]), int(parts[2]),
                          np.asarray([x, y, z, qw, qx, qy, qz], np.float32),
                          info))
    kernels = {}
    if kernels_path and Path(kernels_path).exists():
        for line in Path(kernels_path).read_text().splitlines():
            parts = line.split()
            if len(parts) == 4:
                kernels[(int(parts[0]), int(parts[1]))] = (
                    parts[2], float(parts[3]))
    gs = GraphSLAM(capacity_nodes=max(64, len(vertices)),
                   capacity_edges=max(64, len(edges)), device=device)
    id_map = {vid: gs.add_se3_node(vertices[vid], fixed=vid in fixed)
              for vid in sorted(vertices)}
    for a, b, meas, info in edges:
        kernel, delta = kernels.get((a, b), ("NONE", 1.0))
        gs.add_se3_edge(id_map[a], id_map[b], meas, info, kernel=kernel,
                        kernel_delta=delta)
    return gs
