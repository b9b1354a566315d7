"""The distributed solve's dry run: the twin of the JAX package's
`__graft_entry__.dryrun_multichip`, over torch.distributed ranks.

Two graphs, each solved over `n_ranks` ranks (processes on the card, or
the CPU) and on one device:

1. a 256-node noisy ring with every edge family (long-range Huber
   chords every 16 nodes, XYZ and quaternion priors every 32nd node, a
   fixed floor plane with SE3-plane edges every 8 nodes, a free plane
   with normal and distance priors and a plane-identity edge), started
   from the chordal estimate and solved by the dense LM (20 iterations)
   on edge shards. Held to the single-device solve: chi2 within 1e-3
   relative, the largest pose divergence under 1.0 m (the flat valley of
   equal chi2 on this deliberately conflicted graph), and a single-device
   LM restarted at the distributed solution improving chi2 by less than
   1e-3 relative (the distributed result is at the optimum, not stalled);
2. a 2048-node ring with Huber chords every 64 nodes, "auto" with a
   6000-dof dense envelope, so the chain backend with its segment panels
   split over the ranks (24 iterations). Held to the single-device
   chain: chi2 within 5e-3 relative and under a tenth of the start, the
   largest pose divergence under 1.0 m.

Every rank must return bitwise the same poses. These are the JAX dry
run's own bounds.

    python -m mrg_slam_tpu_torch.parallel.dryrun [n_ranks] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from ..config import OptimizerConfig
from ..graph import solve
from ..graph.chordal import chordal_init
from ..runtime import DeviceLike, resolve_device
from ..utils import se3np
from . import dist_solver as ds

INFO = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)


def family_ring(n: int = 256):
    """The first graph (a GraphSLAM on the CPU): `__graft_entry__.py`'s
    all-families ring."""
    from ..pipeline.baseline_runs import build_ring_graph

    gs = build_ring_graph(n_nodes=n, capacity_nodes=n + 8,
                          capacity_edges=2 * n + 64, backend="cg", seed=0,
                          device="cpu")
    for i in range(0, n - n // 2, 16):
        j = i + n // 2
        gs.add_se3_edge(i, j, se3np.pose_between(gs.poses[i], gs.poses[j]),
                        INFO * 0.25, kernel="Huber", kernel_delta=1.0)
    for i in range(0, n, 32):
        gs.add_se3_prior_xyz_edge(i, gs.poses[i][:3], np.eye(3) * 25.0)
        gs.add_se3_prior_quat_edge(i, gs.poses[i][3:7], np.eye(3) * 4.0)
    plane = gs.add_plane_node([0, 0, 1, 0], fixed=True)
    for i in range(0, n, 8):
        gs.add_se3_plane_edge(i, plane, [0, 0, 1, 0], np.eye(3) * 10.0)
    plane2 = gs.add_plane_node([0.05, 0.0, 0.998, 0.1])
    gs.add_plane_prior_normal_edge(plane2, [0, 0, 1], np.eye(3) * 5.0)
    gs.add_plane_prior_distance_edge(plane2, 0.0, 5.0)
    gs.add_plane_identity_edge(plane, plane2, [0, 0, 0, 0], np.eye(4) * 2.0)
    return gs


def chain_ring(n: int = 2048):
    """The second graph: a ring with Huber chords every 64 nodes."""
    from ..pipeline.baseline_runs import build_ring_graph

    gs = build_ring_graph(n_nodes=n, capacity_nodes=n,
                          capacity_edges=2 * n + 64, backend="chain", seed=4,
                          device="cpu")
    for i in range(0, n - n // 2, 64):
        j = i + n // 2
        gs.add_se3_edge(i, j, se3np.pose_between(gs.poses[i], gs.poses[j]),
                        INFO * 0.25, kernel="Huber", kernel_delta=1.0)
    return gs


def _max_div(a: np.ndarray, b: np.ndarray, n: int) -> float:
    return float(np.abs(a[:n, :3] - b[:n, :3]).max())


def dryrun_multichip(n_ranks: int = 8, device: DeviceLike = None,
                     n_family: int = 256, n_chain: int = 2048) -> Dict:
    """Run both graphs over `n_ranks` ranks on `device` (the card unless
    said otherwise) and on one device, assert the bounds above, print
    what was found and return it."""
    dev = resolve_device(device)

    def progress(msg):
        print(f"dryrun: {msg}", flush=True)

    gs = family_ring(n_family)
    snap = gs.snapshot()
    snap = snap._replace(poses=chordal_init(snap))
    cfg = OptimizerConfig(solver_backend="dense",
                          g2o_solver_num_iterations=20,
                          cg_max_iterations=96)
    gs2 = chain_ring(n_chain)
    g2 = gs2.snapshot()
    cfg2 = OptimizerConfig(solver_backend="auto", auto_dense_max_dofs=6000,
                           g2o_solver_num_iterations=24)
    progress(f"graphs built: {n_family} nodes, {gs.num_edges} se3 edges, "
             f"{gs._priors.n} priors, {gs.num_plane_edges} plane edges; "
             f"{n_chain} nodes, {gs2.num_edges} se3 edges (auto -> "
             f"{solve.resolve_backend('auto', n_chain, 0, 6000)})")
    t0 = time.perf_counter()
    ranks = ds.run_ranks(ds.solve_graphs, n_ranks, dev,
                         args=([(snap, cfg), (g2, cfg2)],))
    run_s = time.perf_counter() - t0
    if not ds.ranks_equal(ranks):
        raise AssertionError("the ranks' poses differ")
    res, res_c = ranks[0]
    progress(f"{n_ranks} ranks ({ds.group_backend(dev, n_ranks)}) done in "
             f"{run_s:.1f} s, every rank bitwise equal: dense chi2 "
             f"{res['chi2_initial']:.1f} -> {res['chi2_final']:.1f} "
             f"({res['iterations']} LM iterations, {res['wall_s']:.2f} s)")

    chi2_0, chi2_1 = res["chi2_initial"], res["chi2_final"]
    if not (np.isfinite(chi2_1) and chi2_1 < chi2_0):
        raise AssertionError((chi2_0, chi2_1))
    if not np.isfinite(res["planes"][:2]).all():
        raise AssertionError("planes not finite")
    one = solve.optimize(ds.graph_to(snap, dev), cfg)
    chi2_one = float(one.chi2_final)
    rel = abs(chi2_1 - chi2_one) / max(chi2_one, 1e-9)
    if not rel < 1e-3:
        raise AssertionError(f"dense chi2 {chi2_1} vs one device "
                             f"{chi2_one}: rel {rel:.3g}")
    max_div = _max_div(res["poses"], one.poses.cpu().numpy(), n_family)
    if not max_div < 1.0:
        raise AssertionError(f"dense pose divergence {max_div} m")
    polish = solve.optimize(ds.graph_to(snap._replace(
        poses=torch.from_numpy(res["poses"]),
        planes=torch.from_numpy(res["planes"])), dev), cfg)
    chi2_pol = float(polish.chi2_final)
    improved = (chi2_1 - chi2_pol) / max(chi2_1, 1e-9)
    moved = _max_div(polish.poses.cpu().numpy(), res["poses"], n_family)
    if not (improved < 1e-3 and moved < 1.0):
        raise AssertionError(f"polish improved chi2 by {improved:.3g} "
                             f"(moved {moved} m)")
    progress(f"parity vs one device: chi2 {chi2_1:.3f} vs {chi2_one:.3f} "
             f"(rel {rel:.2e}), pose divergence {max_div:.2e} m; polish "
             f"improved chi2 by {improved:.2e} rel (moved {moved:.2e} m)")

    one_c = solve.optimize(ds.graph_to(g2, dev), cfg2)
    chi_c1, chi_c = float(one_c.chi2_final), res_c["chi2_final"]
    rel_c = abs(chi_c1 - chi_c) / max(chi_c1, 1e-9)
    div_c = _max_div(res_c["poses"], one_c.poses.cpu().numpy(), n_chain)
    if not (chi_c < 0.1 * res_c["chi2_initial"] and rel_c < 5e-3
            and div_c < 1.0):
        raise AssertionError(f"chain: chi2 {res_c['chi2_initial']} -> "
                             f"{chi_c}, one device {chi_c1} (rel "
                             f"{rel_c:.3g}), divergence {div_c} m")
    progress(f"chain ({n_chain} nodes, K "
             f"{solve._chain_K(n_chain, n_ranks)}): chi2 "
             f"{res_c['chi2_initial']:.1f} -> {chi_c:.3f} over {n_ranks} "
             f"ranks ({res_c['iterations']} LM iterations, "
             f"{res_c['wall_s']:.2f} s), one device {chi_c1:.3f} (rel "
             f"{rel_c:.2e}), pose divergence {div_c:.2e} m")
    return {"ranks": n_ranks, "backend": ds.group_backend(dev, n_ranks),
            "dense": {"nodes": n_family, "chi2_initial": chi2_0,
                      "chi2": chi2_1, "chi2_one_device": chi2_one,
                      "rel": rel, "max_pose_divergence_m": max_div,
                      "polish_improvement": improved,
                      "iterations": res["iterations"],
                      "wall_s": res["wall_s"],
                      "all_reduces": res["all_reduces"],
                      "all_reduce_ms": res["all_reduce_s"] * 1e3
                      / max(res["all_reduces"], 1)},
            "chain": {"nodes": n_chain, "chi2_initial": res_c["chi2_initial"],
                      "chi2": chi_c, "chi2_one_device": chi_c1, "rel": rel_c,
                      "max_pose_divergence_m": div_c,
                      "iterations": res_c["iterations"],
                      "wall_s": res_c["wall_s"],
                      "all_reduces": res_c["all_reduces"],
                      "all_reduce_ms": res_c["all_reduce_s"] * 1e3
                      / max(res_c["all_reduces"], 1)},
            "peak_allocated_bytes": [r[1]["peak_allocated_bytes"]
                                     for r in ranks],
            "run_s": run_s}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("n_ranks", nargs="?", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args()
    dryrun_multichip(a.n_ranks, device=a.device)
