"""Loop detection: candidate filtering, batched matching, consistency check.

Counterpart of the JAX package's models/loop_detector.py
(src/mrg_slam/loop_detector.cpp). The reference registers each candidate
serially against the new keyframe (:97-188) and then runs one or two more
registrations for the odom-chain consistency check (:190-303). Here a
tick's pair work runs through the PairRunner (models/pair_runner.py):
every candidate of every pending new keyframe, the consistency-check
registrations of every candidate (speculative: their init poses depend
only on graph estimates) and the tick's deferred edge-fitness rows, in
one batch; or, when the speculative rows would cost more than
`PairRunner.speculation_budget_rows` allows, the candidates first and the
winners' checks in a second, small batch.

Candidate filtering (:40-95) stays on host numpy; selection and the
composed-cycle test (loop ∘ odom ∘ loop^-1 ≈ I) are host math over the
batch read back.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import LoopClosureConfig, RegistrationConfig
from ..utils import profiling, se3np
from .graph_database import GraphDatabase, Loop
from .keyframe import KeyFrame
from .pair_runner import PairRequest, PairRunner


class LoopManager:
    """Most-recent-loop map per (slam_uuid_new, slam_uuid_candidate)
    (loop_detector.hpp:39-117), accum-distance-keeps-newest semantics."""

    def __init__(self):
        self._map: Dict[str, Dict[str, Loop]] = {}

    def get_loop(self, new_slam_uuid: str, cand_slam_uuid: str
                 ) -> Optional[Loop]:
        return self._map.get(new_slam_uuid, {}).get(cand_slam_uuid)

    def add_loop(self, loop: Loop) -> None:
        self._map.setdefault(loop.key1.slam_uuid, {})[
            loop.key2.slam_uuid] = loop

    def add_loop_accum_distance_check(self, loop: Loop) -> None:
        cur = self.get_loop(loop.key1.slam_uuid, loop.key2.slam_uuid)
        if cur is None or loop.key1.accum_distance > cur.key1.accum_distance:
            self.add_loop(loop)


class LoopDetector:
    def __init__(self, cfg: LoopClosureConfig, reg_cfg: RegistrationConfig):
        self.cfg = cfg
        self.reg_cfg = reg_cfg
        self.loop_manager = LoopManager()
        self.runner = PairRunner(reg_cfg)
        # stats mirroring loop_detector.hpp:140-141
        self.loop_detection_times: List[float] = []

    # ------------------------------------------------------------------
    def detect(self, db: GraphDatabase,
               extra_requests: Tuple[PairRequest, ...] = ()
               ) -> Tuple[List[Loop], List]:
        """loop_detector.cpp:15: scan every pending new keyframe — batched.

        Returns (loops, extra_results): each Loop carries the ungated
        fitness of its aligned pair so `insert_loops` can weight the edge
        without another pass. `extra_requests` (the tick's odometry-edge
        fitness passes) ride in the same batch; their results come back
        in order.
        """
        t0 = time.perf_counter()
        requests, jobs, check_slices = self.build_requests(db,
                                                           extra_requests)
        if not requests:
            return [], []

        # the batch's shape: speculative check rows while they stay under
        # the runner's budget, else two phases (PairRunner's cost model,
        # the JAX package's, measured on a TPU)
        n_check = sum(len(checks)
                      for (_, checks) in check_slices.values())
        cap0 = requests[0].target.cloud.capacity
        if n_check > self.runner.speculation_budget_rows(cap0):
            phase1 = requests[: len(requests) - n_check]
            results = self.runner.run(phase1)
            extra_results = results[: len(extra_requests)]
            loops = self._resolve_two_phase(db, jobs, results,
                                            len(extra_requests))
        else:
            results = self.runner.run(requests)
            extra_results = results[: len(extra_requests)]
            loops = self.resolve(jobs, check_slices, results,
                                 len(extra_requests))
        if jobs:
            self.loop_detection_times.append(
                (time.perf_counter() - t0) * 1e6)
        return loops, extra_results

    # -- batch construction and resolution --------------------------------
    def build_requests(self, db: GraphDatabase,
                       extra_requests: Tuple[PairRequest, ...] = ()):
        """Every pair row of the tick in one batch: [extras][candidate
        registrations][speculative consistency checks].

        The consistency-check registrations (loop_detector.cpp:190-241)
        depend on the candidates' results only through which candidate
        won, since their init poses come from graph estimates alone; so
        the checks of every candidate ride the same batch and `resolve`
        reads the winner's rows.

        Returns (requests, jobs, check_slices) where jobs[j] =
        (new_kf, candidates) maps to result rows in order after the
        extras, and check_slices[(j, c)] = (row_offset, checks) locates
        candidate c's neighbor-check rows.
        """
        with profiling.span("loops.build"):
            jobs: List[Tuple[KeyFrame, List[KeyFrame]]] = []
            requests: List[PairRequest] = list(extra_requests)
            for new_kf in db.new_keyframes:
                candidates = self.find_candidates(new_kf, db)
                if not candidates:
                    continue
                new_est = new_kf.estimate(db.graph)
                for cand in candidates:
                    requests.append(PairRequest(
                        target=new_kf, source=cand,
                        init_pose=self._guess(new_est,
                                              cand.estimate(db.graph)),
                        max_iters=self.reg_cfg.reg_maximum_iterations,
                        fitness_max_range=self.cfg.fitness_score_max_range))
                jobs.append((new_kf, candidates))

            check_slices = {}
            if self.cfg.enable_loop_closure_consistency_check:
                for j, (new_kf, candidates) in enumerate(jobs):
                    new_est = np.asarray(new_kf.estimate(db.graph))
                    for c, cand in enumerate(candidates):
                        if cand.first_keyframe or cand.static_keyframe:
                            continue  # direct accept if selected — no checks
                        checks = self._neighbor_checks(cand, db)
                        check_slices[(j, c)] = (len(requests), checks)
                        for nb_kf, odom_rel, kind in checks:
                            requests.append(PairRequest(
                                target=new_kf, source=nb_kf,
                                init_pose=self._guess(
                                    new_est, nb_kf.estimate(db.graph)),
                                max_iters=self.reg_cfg.reg_maximum_iterations))
            return requests, jobs, check_slices

    def _select(self, jobs, results, k: int):
        """Phase-1 selection: best gated fitness per new keyframe,
        skipping non-converged candidates, thresholded on
        fitness_score_thresh (loop_detector.cpp:150-160). Returns
        [(job_idx, new_kf, winner, winner_idx, winner_result)]."""
        winners = []
        for j, (new_kf, candidates) in enumerate(jobs):
            best, best_c = None, -1
            best_score = float("inf")
            best_res = None
            for c, cand in enumerate(candidates):
                res = results[k]
                k += 1
                if not res.converged or not np.isfinite(res.fitness_range):
                    continue
                if res.fitness_range < best_score:
                    best, best_score, best_res, best_c = (
                        cand, res.fitness_range, res, c)
            if best is None or best_score > self.cfg.fitness_score_thresh:
                continue
            winners.append((j, new_kf, best, best_c, best_res))
        return winners

    def _check_exempt(self, best: KeyFrame) -> bool:
        return (not self.cfg.enable_loop_closure_consistency_check
                or best.first_keyframe or best.static_keyframe)

    def resolve(self, jobs, check_slices, results, n_extra: int
                ) -> List[Loop]:
        """Selection + consistency acceptance over the single speculative
        batch. Acceptance: composed-cycle test (loop ∘ odom ∘ loop^-1 ≈ I)
        on the winner's precomputed neighbor-check rows
        (loop_detector.cpp:243-303)."""
        with profiling.span("loops.resolve"):
            loops: List[Loop] = []
            for j, new_kf, best, best_c, best_res in self._select(
                    jobs, results, n_extra):
                if self._check_exempt(best):
                    loops.append(self._accept(new_kf, best, best_res))
                    continue
                off, checks = check_slices[(j, best_c)]
                if not checks:
                    continue  # no odom neighbors to verify against -> reject
                ok = False
                for i, (nb_kf, odom_rel, kind) in enumerate(checks):
                    if ok:
                        continue
                    if self._cycle_closes(best_res.pose, results[off + i].pose,
                                          odom_rel, kind):
                        ok = True
                if ok:
                    loops.append(self._accept(new_kf, best, best_res))
            return loops

    def _resolve_two_phase(self, db: GraphDatabase, jobs, results,
                           n_extra: int) -> List[Loop]:
        """Acceptance for busy ticks: select winners from the
        candidate-only batch, then run only the winners' odom-neighbour
        consistency registrations as a second, small batch: the
        reference's own ordering (loop_detector.cpp:190-303)."""
        with profiling.span("loops.resolve"):
            winners = self._select(jobs, results, n_extra)
            loops: List[Loop] = []
            pending = []  # (new_kf, best, best_res, checks, row_offset)
            check_reqs: List[PairRequest] = []
            for j, new_kf, best, best_c, best_res in winners:
                if self._check_exempt(best):
                    loops.append(self._accept(new_kf, best, best_res))
                    continue
                checks = self._neighbor_checks(best, db)
                if not checks:
                    continue  # no odom neighbors to verify against -> reject
                new_est = np.asarray(new_kf.estimate(db.graph))
                pending.append((new_kf, best, best_res, checks,
                                len(check_reqs)))
                for nb_kf, odom_rel, kind in checks:
                    check_reqs.append(PairRequest(
                        target=new_kf, source=nb_kf,
                        init_pose=self._guess(new_est,
                                              nb_kf.estimate(db.graph)),
                        max_iters=self.reg_cfg.reg_maximum_iterations))
            if check_reqs:
                check_results = self.runner.run(check_reqs)
                for new_kf, best, best_res, checks, off in pending:
                    ok = False
                    for i, (nb_kf, odom_rel, kind) in enumerate(checks):
                        if ok:
                            continue
                        if self._cycle_closes(best_res.pose,
                                              check_results[off + i].pose,
                                              odom_rel, kind):
                            ok = True
                    if ok:
                        loops.append(self._accept(new_kf, best, best_res))
            return loops

    # ------------------------------------------------------------------
    def _guess(self, new_est, cand_est) -> np.ndarray:
        """Initial guess = relative pose between current graph estimates,
        optionally planarized (loop_detector.cpp:125-133)."""
        g = se3np.pose_between(new_est, cand_est)
        if self.cfg.use_planar_registration_guess:
            g[2] = 0.0
        return g

    def _accept(self, new_kf: KeyFrame, best: KeyFrame, res) -> Loop:
        loop = Loop(key1=new_kf, key2=best,
                    relative_pose=np.asarray(res.pose, np.float32),
                    fitness=res.fitness_inf)
        self.loop_manager.add_loop(loop)
        return loop

    # ------------------------------------------------------------------
    def find_candidates(self, new_kf: KeyFrame,
                        db: GraphDatabase) -> List[KeyFrame]:
        """Host-side filters (loop_detector.cpp:40-95)."""
        cfg = self.cfg
        out: List[Tuple[float, KeyFrame]] = []
        new_est = new_kf.estimate(db.graph)
        for cand in db.keyframes:
            if cand.node_id is None or cand.first_keyframe:
                continue
            if db.edge_exists(new_kf, cand):
                continue
            cand_est = cand.estimate(db.graph)
            d2 = float(np.sum((cand_est[:2] - new_est[:2]) ** 2))
            if d2 > cfg.candidate_max_xy_distance ** 2:
                continue
            same = new_kf.slam_uuid == cand.slam_uuid
            if same and (new_kf.accum_distance - cand.accum_distance
                         < cfg.accum_distance_thresh_same_robot):
                continue
            last = self.loop_manager.get_loop(new_kf.slam_uuid,
                                              cand.slam_uuid)
            if last is not None:
                gap = new_kf.accum_distance - last.key1.accum_distance
                thresh = (cfg.accum_distance_thresh_same_robot if same
                          else cfg.accum_distance_thresh_other_robot)
                if gap < thresh:
                    continue
            out.append((d2, cand))
        # static batch cap: keep the spatially closest candidates
        out.sort(key=lambda t: t[0])
        return [c for _, c in out[: self.cfg.capacity_candidates]]

    # ------------------------------------------------------------------
    def _neighbor_checks(self, best: KeyFrame, db: GraphDatabase):
        """The candidate's prev/next odom-chain neighbors
        (loop_detector.cpp:216-241)."""
        checks = []
        if best.prev_edge is not None:
            prev_kf = db.uuid_keyframe_map.get(best.prev_edge.to_uuid)
            if prev_kf is not None and prev_kf.node_id is not None:
                # prev_edge: from=best, to=prev; meas = T_best_prev
                checks.append((prev_kf, best.prev_edge.relative_pose, "prev"))
        if best.next_edge is not None:
            next_kf = db.uuid_keyframe_map.get(best.next_edge.from_uuid)
            if next_kf is not None and next_kf.node_id is not None:
                # next_edge: from=next, to=best; meas = T_next_best
                checks.append((next_kf, best.next_edge.relative_pose, "next"))
        return checks

    def _cycle_closes(self, rel_new_best, rel_new_nb, odom_rel,
                      kind: str) -> bool:
        """loop ∘ odom ∘ loop^-1 ≈ I within max_delta_trans/angle
        (loop_detector.cpp:243-303)."""
        if kind == "prev":
            # T_new_prev^-1 * T_new_best * T_best_prev ≈ I
            cyc = se3np.pose_compose(
                se3np.pose_compose(se3np.pose_inverse(rel_new_nb),
                                   rel_new_best), odom_rel)
        else:
            # T_new_best^-1 * T_new_next * T_next_best ≈ I
            cyc = se3np.pose_compose(
                se3np.pose_compose(se3np.pose_inverse(rel_new_best),
                                   rel_new_nb), odom_rel)
        dt = float(np.linalg.norm(cyc[:3]))
        da = se3np.rotation_angle(cyc[3:7])
        return (dt <= self.cfg.loop_closure_consistency_max_delta_trans
                and da <= self.cfg.loop_closure_consistency_max_delta_angle)
