"""Robots that share a card share each tick's device programs.

Counterpart of the JAX package's models/coordinator.py. The reference
runs one MrgSlamComponent process per robot, each with its own
optimization timer (apps/mrg_slam_component.cpp:802), so R robots pay R
of everything. A pair row is robot-agnostic and the robots' pose graphs
have one shape, so one coordinator runs R robots' optimization ticks in
the two programs one robot's tick runs:

  pairs: every robot's loop-candidate registrations, speculative
         consistency checks and deferred-edge fitness rows in one
         `PairRunner.run` (loop_detector.build_requests / resolve);
  solve: every robot's pose graph in one batched LM
         (graph/builder.optimize_many), one packed read.

The per-robot host logic (queue flushes, candidate filtering, selection,
loop insertion, the odom->map bookkeeping) is `MrgSlam.optimization_tick`'s:
the coordinator drives the same stage methods, and only the device
batching changes. Each robot's TickStats records the shared stages' walls
and pair buckets (the programs serve every robot at once).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

from ..graph.builder import optimize_many
from .backend import MrgSlam, TickStats, _solve_stats, _tick_insert


class SharedTick:
    """Runs R robots' optimization ticks through shared device programs.
    The robots must share a registration config and keyframe cloud
    capacity (one PairRunner serves them all); graphs whose solver
    configs differ solve one by one."""

    def __init__(self, slams: Sequence[MrgSlam]):
        self.slams = list(slams)
        if not self.slams:
            raise ValueError("need at least one robot")
        reg0 = self.slams[0].cfg.registration
        cap0 = self.slams[0].cfg.capacity_keyframe_points
        for s in self.slams[1:]:
            if (s.cfg.registration != reg0
                    or s.cfg.capacity_keyframe_points != cap0):
                raise ValueError(
                    "SharedTick robots must share a registration config and "
                    f"keyframe cloud capacity ({s.own_name} differs)")
        # one runner serves every robot's pair rows (the covariances live
        # on the keyframes)
        self.runner = self.slams[0].loop_detector.runner
        for s in self.slams[1:]:
            s.loop_detector.runner = self.runner

    def tick_all(self, now: float = 0.0) -> Dict[str, Optional[TickStats]]:
        """One coordinated tick of every robot: the same flushes, candidate
        selection, loop acceptance and solve as each robot's
        `optimization_tick(now)` in turn, with the device work batched
        across robots. -> robot name -> its TickStats (None for a robot
        with nothing to do)."""
        out: Dict[str, Optional[TickStats]] = {
            s.own_name: None for s in self.slams}
        begun = []
        for slam in self.slams:
            pre = slam._tick_begin(now)
            if pre is not None:
                begun.append((slam, *pre))
        if not begun:
            return out

        # one batch: every robot's candidate registrations, speculative
        # consistency checks and edge-fitness rows
        t0 = time.perf_counter()
        self.runner.buckets.clear()
        all_reqs, meta = [], []
        for slam, stats, deferred, edge_reqs in begun:
            slam.status.in_loop_closure = True
            reqs, jobs, slices = slam.loop_detector.build_requests(
                slam.db, edge_reqs)
            meta.append((slam, stats, deferred, edge_reqs, jobs, slices,
                         len(all_reqs), len(reqs)))
            all_reqs.extend(reqs)
        results = self.runner.run(all_reqs)
        loop_us = (time.perf_counter() - t0) * 1e6
        graphs = []
        for (slam, stats, deferred, edge_reqs, jobs, slices, off,
             n) in meta:
            rs = results[off: off + n]
            loops = slam.loop_detector.resolve(jobs, slices, rs,
                                               len(edge_reqs))
            if jobs:
                slam.loop_detector.loop_detection_times.append(loop_us)
            stats.loop_closure_us = loop_us
            stats.pair_buckets = list(self.runner.buckets)
            slam.status.in_loop_closure = False
            _tick_insert(slam.db, stats, deferred, rs[: len(edge_reqs)],
                         loops)
            slam.status.in_optimization = True
            graphs.append(slam.db.graph)

        # one batched solve of every graph
        t0 = time.perf_counter()
        optimize_many(graphs)
        opt_us = (time.perf_counter() - t0) * 1e6
        for slam, stats, *_ in meta:
            stats.optimization_us = opt_us
            _solve_stats(slam.db.graph, stats)
            slam.status.in_optimization = False
            slam._tick_post(stats)
            out[slam.own_name] = stats
        return out
