"""Synthetic workloads of the acceptance runs.

Counterpart of the JAX package's pipeline/baseline_runs.py; only the ring
pose graph is ported, the workload of the solver section and of
acceptance row 5 (`5_distributed_mesh_solve`). The acceptance runs
themselves wait for ROADMAP.md queue 1 items 10 and 16.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import OptimizerConfig
from ..graph.builder import GraphSLAM
from ..runtime import DeviceLike
from ..utils import se3, se3np


def build_ring_graph(n_nodes=256, capacity_nodes=None, capacity_edges=None,
                     backend="cg", seed=3, noise_scale=0.03,
                     device: DeviceLike = None) -> GraphSLAM:
    """A noisy ring pose graph with one loop edge, on `device` (the card
    unless said otherwise): ground truth on a 20 m circle, odometry
    perturbed by exp of N(0, noise_scale) twists drawn from `seed`,
    estimates accumulated along the chain from a fixed first node, and
    the true last-to-first edge at four times the information. The same
    seed gives the JAX package's graph."""
    rng = np.random.default_rng(seed)
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    gs = GraphSLAM(OptimizerConfig(solver_backend=backend),
                   capacity_nodes=capacity_nodes or max(n_nodes, 64),
                   capacity_edges=capacity_edges or 2 * n_nodes,
                   device=device)
    th = 2 * np.pi * np.arange(n_nodes) / n_nodes
    twists = np.stack([20 * np.cos(th), 20 * np.sin(th), np.zeros(n_nodes),
                       np.zeros(n_nodes), np.zeros(n_nodes), th],
                      axis=1).astype(np.float32)
    gt = se3.pose_exp(torch.from_numpy(twists)).numpy()
    # one (n-1, 6) draw: the generator's sequence of the JAX package's
    noise = se3.pose_exp(torch.from_numpy(rng.normal(
        scale=noise_scale, size=(n_nodes - 1, 6)).astype(np.float32))).numpy()
    est, ids = [gt[0]], [gs.add_se3_node(gt[0], fixed=True)]
    for i in range(1, n_nodes):
        rel = se3np.pose_between(gt[i - 1], gt[i])
        reln = se3np.pose_compose(rel, noise[i - 1])
        est.append(se3np.pose_compose(est[-1], reln))
        ids.append(gs.add_se3_node(est[-1]))
        gs.add_se3_edge(ids[i - 1], ids[i], reln, info)
    gs.add_se3_edge(ids[-1], ids[0],
                    se3np.pose_between(gt[-1], gt[0]), info * 4)
    return gs
