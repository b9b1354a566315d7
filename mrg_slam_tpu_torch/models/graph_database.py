"""GraphDatabase: the keyframe and edge store of one robot, or of R
co-hosted robots, and the uuid merge of other robots' graphs.

Counterpart of the JAX package's models/graph_database.py
(src/mrg_slam/graph_database.cpp) without its persistence merges: it owns
the keyframes and edges (uuid-keyed), the odometry keyframe queue, the
queue of other robots' delta graphs and their merge (`flush_graph_queue`),
one anchor node per robot chain, and loop insertion; the pose graph is
the GraphSLAM builder on the device. One store can hold several robots'
chains (models/shared_graph.py), each with its own previous keyframe,
anchor and keyframe counter; the singular `prev_robot_keyframe`,
`anchor_kf`, `anchor_edge` and `odom_keyframe_counter` are the own
robot's views of that state. The static-keyframe and loaded-graph queues
exist, and their flushes return False while they are empty; anything
queued there raises NotImplementedError, since their merges wait for
ROADMAP.md queue 1 item 16 (persistence).

`queue_lock` guards every queue's append and every flush's swap: the
optimization tick may run on a worker thread while scans come in
(`MrgSlam.optimization_tick_async`), as the reference's optimization
timer runs beside its cloud callback (mrg_slam_component.cpp:805-817).
"""

from __future__ import annotations

import dataclasses
import pathlib
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from ..config import SlamConfig
from ..graph.builder import GraphSLAM
from ..ops import ground_fill
from ..ops.cloud import PointCloud
from ..runtime import DeviceLike
from ..utils import se3np
from .information_matrix import InformationMatrixCalculator
from .keyframe import (EDGE_ANCHOR, EDGE_LOOP, EDGE_ODOM, Edge, KeyFrame,
                       new_uuid)


@dataclasses.dataclass
class Loop:
    key1: KeyFrame            # the new keyframe
    key2: KeyFrame            # the matched candidate
    relative_pose: np.ndarray  # (7,) T_new^-1 T_candidate
    # ungated fitness at relative_pose from the pair program, so that
    # insert_loops weights the edge without another pass
    fitness: Optional[float] = None


class GraphDatabase:
    def __init__(self, cfg: SlamConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.own_name = cfg.own_name
        self.slam_uuid = new_uuid()  # per-run graph instance id
        # the prior and plane tables follow the enabled processors (JAX
        # graph_database.py:42-62): a table of zero capacity costs a solve
        # nothing, so a pose-only deployment pays for its SE3 sweep alone;
        # edges that arrive anyway grow their table by doubling. At most
        # 3 priors a keyframe (GPS xyz, IMU quaternion and vector); the
        # floor processor adds one global plane node and at most one plane
        # edge a keyframe (floor_coeffs_processor.cpp:68-78). The live
        # pipeline creates no plane prior or plane-plane edge.
        use_priors = (cfg.gps.enable_gps or cfg.imu.enable_imu_orientation
                      or cfg.imu.enable_imu_acceleration)
        use_floor = cfg.floor_coeffs.enable_floor_coeffs
        self.graph = GraphSLAM(
            cfg.optimizer, capacity_nodes=cfg.capacity_keyframes,
            capacity_edges=cfg.capacity_edges,
            capacity_priors=2 * cfg.capacity_keyframes if use_priors else 0,
            capacity_planes=2 if use_floor else 0,
            capacity_plane_edges=cfg.capacity_keyframes if use_floor else 0,
            device=device)
        self.inf_calculator = InformationMatrixCalculator(cfg.inf_matrix)

        self.keyframes: List[KeyFrame] = []       # flushed, loop-checked
        self.new_keyframes: List[KeyFrame] = []   # flushed, pending loops
        self.edges: List[Edge] = []
        self.uuid_keyframe_map: Dict[str, KeyFrame] = {}
        self.edge_uuids: Set[str] = set()
        self.edge_pairs: Set[Tuple[str, str]] = set()  # (from, to) uuids

        self.keyframe_queue: List[KeyFrame] = []
        self.static_keyframe_queue: List[KeyFrame] = []
        self.graph_queue: List[object] = []   # other robots' GraphMsgs
        self.loaded_graph_queue: List[object] = []
        self.queue_lock = threading.Lock()

        # per-robot chain state: latest keyframe, (anchor keyframe, anchor
        # edge) and keyframe counter, by robot name
        self._prev_kf: Dict[str, KeyFrame] = {}
        self._anchors: Dict[str, Tuple[KeyFrame, Edge]] = {}
        self._odom_counters: Dict[str, int] = {}
        self._save_counter = 0  # save_keyframe_poses file numbering
        # the latest keyframe of each other robot whose graph was merged:
        # name -> (uuid, its odometry pose)
        self.others_last_kf: Dict[str, Tuple[str, np.ndarray]] = {}

    # -- the own robot's views of the per-chain state --------------------
    @property
    def prev_robot_keyframe(self) -> Optional[KeyFrame]:
        return self._prev_kf.get(self.own_name)

    def prev_keyframe_of(self, robot_name: str) -> Optional[KeyFrame]:
        return self._prev_kf.get(robot_name)

    @property
    def anchor_kf(self) -> Optional[KeyFrame]:
        pair = self._anchors.get(self.own_name)
        return pair[0] if pair else None

    @property
    def anchor_edge(self) -> Optional[Edge]:
        pair = self._anchors.get(self.own_name)
        return pair[1] if pair else None

    @property
    def odom_keyframe_counter(self) -> int:
        return self._odom_counters.get(self.own_name, 0)

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def add_odom_keyframe(self, stamp: float, odom: np.ndarray,
                          accum_distance: float, cloud: PointCloud,
                          robot_name: Optional[str] = None,
                          slam_uuid: Optional[str] = None) -> KeyFrame:
        """graph_database.cpp:35: assign uuid and counter, queue for the
        next flush. `robot_name` and `slam_uuid` (default: the own robot's
        and the store's) name the chain when one store holds several."""
        name = robot_name or self.own_name
        counter = self._odom_counters.get(name, 0)
        kf = KeyFrame(robot_name=name, stamp=stamp,
                      odom=np.asarray(odom, np.float32),
                      accum_distance=accum_distance, cloud=cloud,
                      slam_uuid=slam_uuid or self.slam_uuid,
                      odom_counter=counter)
        self._odom_counters[name] = counter + 1
        with self.queue_lock:
            self.keyframe_queue.append(kf)
        return kf

    def add_graph_msg(self, msg) -> None:
        """Queue another robot's delta graph (a GraphMsg) for the next
        flush."""
        with self.queue_lock:
            self.graph_queue.append(msg)

    # ------------------------------------------------------------------
    # flush: odometry keyframes
    # ------------------------------------------------------------------
    def flush_keyframe_queue(self, odom2map: Union[np.ndarray,
                                                   Dict[str, np.ndarray]],
                             defer_info: bool = False) -> List[Edge]:
        """graph_database.cpp:50: an SE3 node per keyframe and an odometry
        edge to the previous keyframe of its robot's chain; the anchor on
        each chain's first one. `odom2map` is one pose, or a dict robot
        name -> pose when the store holds several robots' chains.

        Returns the new odometry edges. With `defer_info=True` (the
        back-end tick) an edge weighted by fitness gets
        `information=None` and no solver entry yet: the tick computes
        every edge fitness in its pair program and then calls
        `finalize_edges`. Without it, each edge's fitness pass runs here.
        """
        with self.queue_lock:
            if not self.keyframe_queue:
                return []
            n = min(len(self.keyframe_queue),
                    self.cfg.max_keyframes_per_update)
            batch = self.keyframe_queue[:n]
            del self.keyframe_queue[:n]
        pending: List[Edge] = []
        const_info = self.cfg.inf_matrix.use_const_inf_matrix
        for kf in batch:
            o2m = (odom2map[kf.robot_name] if isinstance(odom2map, dict)
                   else odom2map)
            est = se3np.pose_compose(o2m, kf.odom)
            kf.node_id = self.graph.add_se3_node(est)
            self.uuid_keyframe_map[kf.uuid] = kf
            self.new_keyframes.append(kf)

            prev = self._prev_kf.get(kf.robot_name)
            self._prev_kf[kf.robot_name] = kf
            if prev is None:
                self._handle_first_keyframe(kf, est)
                continue
            rel = se3np.pose_between(kf.odom, prev.odom)
            if const_info:
                info = self.inf_calculator.from_fitness(0.0)
            elif defer_info:
                info = None
            else:
                info = self.inf_calculator.calc_information_matrix(
                    kf.cloud, prev.cloud, rel)
            edge = Edge(type=EDGE_ODOM, from_uuid=kf.uuid, to_uuid=prev.uuid,
                        relative_pose=rel, information=info,
                        from_readable=kf.readable_id,
                        to_readable=prev.readable_id,
                        robust_kernel=self.cfg.odometry_edge_robust_kernel,
                        robust_kernel_size=(
                            self.cfg.odometry_edge_robust_kernel_size))
            if info is not None:
                edge.edge_id = self.graph.add_se3_edge(
                    kf.node_id, prev.node_id, rel, info,
                    kernel=edge.robust_kernel,
                    kernel_delta=edge.robust_kernel_size)
            self._register_edge(edge)
            pending.append(edge)
            kf.prev_edge = edge
            prev.next_edge = edge
        return pending

    def finalize_edges(self, edges: Sequence[Edge],
                       fitness: Sequence[float]) -> None:
        """Attach fitness-derived information matrices to deferred odometry
        edges and enter them into the solver tables."""
        for edge, fit in zip(edges, fitness):
            if edge.edge_id is not None:
                continue  # const-info edges were finalized at flush
            edge.information = self.inf_calculator.from_fitness(
                self.inf_calculator.clamp_fitness(fit))
            kf_from = self.uuid_keyframe_map[edge.from_uuid]
            kf_to = self.uuid_keyframe_map[edge.to_uuid]
            edge.edge_id = self.graph.add_se3_edge(
                kf_from.node_id, kf_to.node_id, edge.relative_pose,
                edge.information, kernel=edge.robust_kernel,
                kernel_delta=edge.robust_kernel_size)

    def _handle_first_keyframe(self, kf: KeyFrame, est: np.ndarray) -> None:
        """A chain's first keyframe: its cloud filled with a ground disc
        when configured (:114-129, src/pcl/fill_ground_plane.cpp), and a
        fixed anchor node at identity with an SE3 edge from it holding the
        first pose (graph_database.cpp:84-112)."""
        kf.first_keyframe = True
        if self.cfg.enable_fill_first_cloud:
            if self.cfg.fill_first_cloud_simple:
                kf.cloud = ground_fill.fill_ground_plane_simple(
                    kf.cloud, est, self.cfg.fill_first_cloud_radius,
                    self.cfg.map_cloud_resolution)
            else:
                kf.cloud = ground_fill.fill_ground_plane_ransac(
                    kf.cloud, self.cfg.fill_first_cloud_radius,
                    self.cfg.map_cloud_resolution)
        if not self.cfg.use_custom_inf_matrix_first_node:
            return
        std = np.asarray(self.cfg.custom_inf_matrix_first_node_stddev)
        info = np.diag(1.0 / (std * std)).astype(np.float32)
        anchor_id = self.graph.add_se3_node(se3np.pose_identity(),
                                            fixed=True)
        anchor_kf = KeyFrame(
            robot_name=kf.robot_name, stamp=0.0,
            odom=se3np.pose_identity(), accum_distance=-1.0,
            cloud=PointCloud.empty(1, device=self.graph.device),
            slam_uuid=kf.slam_uuid, odom_counter=-1)
        anchor_kf.node_id = anchor_id
        self.uuid_keyframe_map[anchor_kf.uuid] = anchor_kf
        edge = Edge(type=EDGE_ANCHOR, from_uuid=anchor_kf.uuid,
                    to_uuid=kf.uuid, relative_pose=est, information=info,
                    from_readable="anchor", to_readable=kf.readable_id)
        edge.edge_id = self.graph.add_se3_edge(anchor_id, kf.node_id, est,
                                               info)
        self._anchors[kf.robot_name] = (anchor_kf, edge)
        self._register_edge(edge)

    def _register_edge(self, edge: Edge) -> None:
        self.edges.append(edge)
        self.edge_uuids.add(edge.uuid)
        self.edge_pairs.add((edge.from_uuid, edge.to_uuid))

    # ------------------------------------------------------------------
    # flush: other robots' delta graphs (the uuid merge)
    # ------------------------------------------------------------------
    def flush_graph_queue(self, loop_manager=None) -> bool:
        """graph_database.cpp:237: merge other robots' delta graphs.

        A new remote keyframe becomes a node at the sender's estimate;
        edges re-link by uuid, and one already known (`edge_uuids`) or
        whose ends are not merged yet is skipped; remote anchors are
        skipped (each robot anchors itself, and the anchor keyframe is
        not sent). A loop edge takes the loop kernel and is registered
        with `loop_manager`, so the local loop search keeps its rate
        limit; an odometry edge links its ends' `prev_edge` and
        `next_edge`. Returns whether anything was queued."""
        with self.queue_lock:
            if not self.graph_queue:
                return False
            msgs, self.graph_queue = self.graph_queue, []
        lc = self.cfg.loop
        for msg in msgs:
            for kmsg in msg.keyframes:
                if kmsg.uuid in self.uuid_keyframe_map:
                    continue
                kf = KeyFrame(
                    robot_name=kmsg.robot_name, stamp=kmsg.stamp,
                    odom=np.asarray(kmsg.estimate, np.float32),
                    accum_distance=kmsg.accum_distance, cloud=kmsg.cloud,
                    uuid=kmsg.uuid, slam_uuid=kmsg.slam_uuid,
                    odom_counter=kmsg.odom_counter,
                    first_keyframe=kmsg.first_keyframe,
                    static_keyframe=kmsg.static_keyframe)
                kf.node_id = self.graph.add_se3_node(kf.odom)
                self.uuid_keyframe_map[kf.uuid] = kf
                self.new_keyframes.append(kf)
            for emsg in msg.edges:
                if emsg.uuid in self.edge_uuids:
                    continue
                kf_from = self.uuid_keyframe_map.get(emsg.from_uuid)
                kf_to = self.uuid_keyframe_map.get(emsg.to_uuid)
                if (kf_from is None or kf_to is None
                        or emsg.type == EDGE_ANCHOR):
                    continue  # an end not merged yet, or a remote anchor
                loop = emsg.type == EDGE_LOOP
                edge = Edge(type=emsg.type, from_uuid=emsg.from_uuid,
                            to_uuid=emsg.to_uuid,
                            relative_pose=np.asarray(emsg.relative_pose,
                                                     np.float32),
                            information=np.asarray(emsg.information,
                                                   np.float32).reshape(6, 6),
                            uuid=emsg.uuid,
                            from_readable=kf_from.readable_id,
                            to_readable=kf_to.readable_id)
                edge.edge_id = self.graph.add_se3_edge(
                    kf_from.node_id, kf_to.node_id, edge.relative_pose,
                    edge.information,
                    kernel=(lc.loop_closure_edge_robust_kernel if loop
                            else "NONE"),
                    kernel_delta=lc.loop_closure_edge_robust_kernel_size)
                self._register_edge(edge)
                if edge.type == EDGE_ODOM:
                    kf_from.prev_edge = edge
                    kf_to.next_edge = edge
                if loop and loop_manager is not None:
                    loop_manager.add_loop(Loop(
                        key1=kf_from, key2=kf_to,
                        relative_pose=edge.relative_pose))
            self.others_last_kf[msg.robot_name] = (
                msg.latest_keyframe_uuid,
                np.asarray(msg.latest_keyframe_odom))
        return True

    # ------------------------------------------------------------------
    # flush: the queues whose merges are not ported yet
    # ------------------------------------------------------------------
    def _refuse(self, queue: list, what: str) -> bool:
        with self.queue_lock:
            if queue:
                raise NotImplementedError(
                    f"{what} are not ported yet: they wait for ROADMAP.md "
                    "queue 1 item 16 (persistence and tooling)")
        return False

    def flush_static_keyframe_queue(self) -> bool:
        return self._refuse(self.static_keyframe_queue, "static keyframes")

    def flush_loaded_graph(self) -> bool:
        return self._refuse(self.loaded_graph_queue, "loaded graphs")

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def insert_loops(self, loops: Sequence[Loop]) -> None:
        """graph_database.cpp:571: loop edges with the robust kernel; the
        new keyframes graduate into the main keyframe list."""
        lc = self.cfg.loop
        for loop in loops:
            if loop.fitness is not None:
                info = self.inf_calculator.from_fitness(
                    self.inf_calculator.clamp_fitness(loop.fitness))
            else:
                info = self.inf_calculator.calc_information_matrix(
                    loop.key1.cloud, loop.key2.cloud, loop.relative_pose)
            edge = Edge(type=EDGE_LOOP, from_uuid=loop.key1.uuid,
                        to_uuid=loop.key2.uuid,
                        relative_pose=np.asarray(loop.relative_pose,
                                                 np.float32),
                        information=info,
                        from_readable=loop.key1.readable_id,
                        to_readable=loop.key2.readable_id,
                        robust_kernel=lc.loop_closure_edge_robust_kernel,
                        robust_kernel_size=(
                            lc.loop_closure_edge_robust_kernel_size))
            edge.edge_id = self.graph.add_se3_edge(
                loop.key1.node_id, loop.key2.node_id, edge.relative_pose,
                info, kernel=edge.robust_kernel,
                kernel_delta=edge.robust_kernel_size)
            self._register_edge(edge)
        self.keyframes.extend(self.new_keyframes)
        self.new_keyframes.clear()

    # ------------------------------------------------------------------
    def edge_exists(self, a: KeyFrame, b: KeyFrame) -> bool:
        return ((a.uuid, b.uuid) in self.edge_pairs
                or (b.uuid, a.uuid) in self.edge_pairs)

    def own_keyframes(self) -> List[KeyFrame]:
        return [k for k in self.keyframes + self.new_keyframes
                if k.robot_name == self.own_name and k.odom_counter >= 0]

    def optimize(self, num_iterations: Optional[int] = None) -> float:
        return self.graph.optimize(num_iterations)

    def save_keyframe_poses(self) -> Optional[str]:
        """Per-optimization TUM trajectory snapshot into
        `<result_dir>/<name>/<name>_NNNN.txt` (graph_database.cpp:599-639).
        No-op when result_dir is unset. Returns the written path."""
        if not self.cfg.result_dir:
            return None
        name = self.own_name or "no_namespace"
        d = pathlib.Path(self.cfg.result_dir) / name
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"{name}_{self._save_counter:04d}.txt"
        self._save_counter += 1
        with open(path, "w") as f:
            for kf in self.keyframes + self.new_keyframes:
                if kf.node_id is None or kf.robot_name != self.own_name:
                    continue
                t = kf.estimate(self.graph)
                # TUM: stamp tx ty tz qx qy qz qw (pose stores wxyz)
                f.write(f"{kf.stamp:.9f} {t[0]} {t[1]} {t[2]} "
                        f"{t[4]} {t[5]} {t[6]} {t[3]}\n")
        return str(path)

    def keyframe_estimates(self) -> np.ndarray:
        """(K, 7) optimized poses of all flushed keyframes, stable order."""
        ids = [k.node_id for k in self.keyframes + self.new_keyframes]
        return self.graph.poses[ids] if ids else np.zeros((0, 7), np.float32)
