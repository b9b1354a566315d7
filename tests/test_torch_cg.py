"""The port's cg family against the JAX package's and against dense
solves: the matrix-free Hessian-vector product, block-Jacobi PCG with
each system stopping on its own, the cg LM backend, the batched-CG
selected-inverse marginals and their routing in GraphSLAM at a capacity
whose default marginals are cg.

Tolerances and why:
- make_hvp against H @ v with H the port's assembled dense Hessian:
  within 1e-5 of the largest entry. Both sum float32 products of the
  same per-edge blocks, in another order.
- pcg_solve run to 1e-7 against a float64 solve of the same damped
  system: within 1e-4 of the largest entry (float32 CG on a loop graph).
  A batch of systems iterates each as long as it would alone: the same
  iteration counts and solutions within 1e-5 of the largest entry (the
  batched products sum in another order, so not bit for bit).
- cg LM against the JAX package's cg LM: chi2 after within rel 1e-3 (the
  ROADMAP's solver gate) and poses within 1e-3 m. The two packages' CG
  iterates round differently and stop a few iterations apart.
- marginals_selected: within 1e-5 of the JAX package's on the same graph
  (the measured spread is ~2e-6 on entries up to 0.4), and within the JAX
  package's own bar to the exact dense blocks (rtol 0.05, atol 1e-4,
  tests/test_graph.py::test_marginals_selected_matches_dense). The
  live-node solve against the one over the whole capacity: within 1e-6
  of the largest entry (padding adds only zeros, in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.config import OptimizerConfig as JOptimizerConfig
from mrg_slam_tpu.graph import solve as jsolve
from mrg_slam_tpu.graph.builder import GraphSLAM as JGraphSLAM
from mrg_slam_tpu.utils import se3np as jse3np

from mrg_slam_tpu_torch.config import OptimizerConfig
from mrg_slam_tpu_torch.convert import config_from_fields, graph_from_numpy
from mrg_slam_tpu_torch.graph import builder, solve


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Tiny solves: threads only add contention with the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _info(t_std, r_std):
    return np.diag([1 / t_std ** 2] * 3 + [1 / r_std ** 2] * 3).astype(
        np.float32)


def _loop_graph(n=24, cap=32, seed=0, backend="cg"):
    """A noisy circle with a fixed first node, odometry edges and three
    Huber loop edges, in the JAX package's builder with zero-capacity
    aux tables (the back end's layout)."""
    rng = np.random.default_rng(seed)
    cfg = JOptimizerConfig(solver_backend=backend,
                           g2o_solver_num_iterations=64)
    gs = JGraphSLAM(cfg, capacity_nodes=cap, capacity_edges=2 * cap,
                    capacity_planes=0, capacity_priors=0,
                    capacity_plane_edges=0, capacity_plane_priors=0,
                    capacity_plane_plane=0)
    th = 2 * np.pi * np.arange(n) / n
    gt = [np.asarray([10 * np.cos(t), 10 * np.sin(t), 0.0,
                      *jse3np.rpy_to_quat(0, 0, t + np.pi / 2)], np.float32)
          for t in th]
    est = [gt[0]]
    gs.add_se3_node(gt[0], fixed=True)
    for i in range(1, n):
        rel = jse3np.pose_between(gt[i - 1], gt[i])
        rel = rel + np.concatenate([rng.normal(scale=0.05, size=3),
                                    np.zeros(4)]).astype(np.float32)
        est.append(jse3np.pose_compose(est[-1], rel))
        gs.add_se3_node(est[-1])
        gs.add_se3_edge(i - 1, i, rel, _info(0.1, 0.05))
    for a, b in ((n - 1, 0), (n // 2, 2), (n - 3, n // 3)):
        gs.add_se3_edge(a, b, jse3np.pose_between(gt[a], gt[b]),
                        _info(0.05, 0.02), kernel="Huber", kernel_delta=1.0)
    return gs


def _port(jgs, device="cpu"):
    return graph_from_numpy(jax.tree.map(np.asarray, jgs.snapshot()),
                            device=device)


def _port_builder(jgs, cfg, cap_nodes, cap_edges):
    """The JAX builder's nodes and edges in the port's GraphSLAM."""
    gs = builder.GraphSLAM(cfg, capacity_nodes=cap_nodes,
                           capacity_edges=cap_edges, device="cpu")
    for i in range(jgs.num_nodes):
        gs.add_se3_node(jgs.poses[i], fixed=bool(jgs.fixed[i]))
    names = {v: k for k, v in builder.KERNEL_IDS.items()}
    a = jgs._se3.arrays
    for e in range(jgs.num_edges):
        gs.add_se3_edge(int(a["from_idx"][e]), int(a["to_idx"][e]),
                        a["meas"][e], a["info"][e],
                        kernel=names[int(a["kernel"][e])],
                        kernel_delta=float(a["delta"][e]))
    return gs


def test_make_hvp_matches_the_dense_hessian():
    g = _port(_loop_graph())
    lin = solve.linearize(g)
    H, _, free = solve.assemble_dense(g, lin)
    # assemble_dense puts a unit diagonal on projected-out dofs; the
    # matrix-free product gives them zero
    H = H - torch.diag(1.0 - free)
    v = torch.from_numpy(np.random.default_rng(1).normal(
        size=(g.n_nodes, 6, 3)).astype(np.float32))
    got, = solve.make_hvp(g, lin)((v,))
    want = (H @ v.reshape(-1, 3)).view(g.n_nodes, 6, 3)
    scale = float(want.abs().max())
    assert scale > 1.0
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert (got[0] == 0).all() and (got[24:] == 0).all()  # fixed, padding


def test_pcg_solve_matches_a_dense_solve_and_stops_each_system():
    g = _port(_loop_graph())
    n = g.n_nodes
    lin = solve.linearize(g)
    hvp = solve.make_hvp(g, lin)
    D, _ = solve.block_diagonal(g, lin)
    d = torch.diagonal(D, dim1=-2, dim2=-1)
    fn, _ = solve._free_masks(g)
    lam = 1e-2
    ridge = (lam * d + 1e-6)[..., None]
    A = lambda v: (hvp(v)[0] + ridge * v[0],)  # noqa: E731
    M = solve._block_jacobi(D, lam, d, fn)
    Minv = lambda v: (M(v[0]),)  # noqa: E731
    rng = np.random.default_rng(2)
    b = torch.from_numpy(rng.normal(size=(n, 6, 3)).astype(np.float32))
    b = b * fn[:, :, None]
    b[..., 1] *= 1e-3      # a system of another scale
    b[..., 2] = 0.0        # and one that is solved before it starts
    (x,), iters = solve.pcg_solve(A, Minv, (b,), 400, 1e-7)
    # float64 reference of the same operator on the free dofs
    H, _, free = solve.assemble_dense(g, lin)
    Hd = H.double() + torch.diag(
        (lam * torch.diagonal(H).double() + 1e-6) * free.double())
    keep = free.bool()
    xd = torch.zeros(6 * n, 3, dtype=torch.float64)
    xd[keep] = torch.linalg.solve(Hd[keep][:, keep],
                                  b.reshape(-1, 3)[keep].double())
    for c in range(2):
        want = xd[:, c].view(n, 6)
        assert float((x[..., c] - want).abs().max()) <= (
            1e-4 * float(want.abs().max()))
    assert iters[2] == 0 and (x[..., 2] == 0).all()
    assert 0 < iters[0] < 400 and 0 < iters[1] < 400
    # each system alone iterates as long as in the batch
    for c in range(3):
        (xc,), ic = solve.pcg_solve(A, Minv, (b[..., c:c + 1].contiguous(),),
                                    400, 1e-7)
        assert int(ic[0]) == int(iters[c])
        scale = max(float(xc.abs().max()), 1e-30)
        assert float((xc[..., 0] - x[..., c]).abs().max()) <= 1e-5 * scale


def test_cg_lm_matches_jax():
    jgs = _loop_graph(n=48, cap=64)
    jcfg = JOptimizerConfig(solver_backend="cg", g2o_solver_num_iterations=64)
    want = jsolve.optimize(jgs.snapshot(), jcfg)
    g = _port(jgs)
    got = solve.optimize(g, config_from_fields(dataclasses.asdict(jcfg)))
    c0, c1 = float(want.chi2_initial), float(want.chi2_final)
    assert c1 < 0.1 * c0  # the loops pulled the circle in
    np.testing.assert_allclose(float(got.chi2_initial), c0, rtol=1e-5)
    np.testing.assert_allclose(float(got.chi2_final), c1, rtol=1e-3)
    assert int(got.cg_iterations) > got.iterations  # CG ran in each step
    n = jgs.num_nodes
    d = np.abs(got.poses.numpy()[:n, :3]
               - np.asarray(want.poses)[:n, :3]).max()
    assert d < 1e-3, d
    np.testing.assert_array_equal(got.poses.numpy()[0],
                                  np.asarray(jgs.poses[0]))


def test_marginals_selected_matches_jax_and_the_dense_blocks():
    jgs = _loop_graph(n=12, cap=16, backend="dense")
    g = _port(jgs)
    g = g._replace(poses=solve.optimize(g, OptimizerConfig(
        solver_backend="dense")).poses)  # at the optimum
    jg = jgs.snapshot()._replace(poses=jnp.asarray(g.poses.numpy()))
    sel = np.asarray([0, 3, 7, 11])
    want = np.asarray(jsolve.marginals_selected(jg, jnp.asarray(sel,
                                                                jnp.int32)))
    got = solve.marginals_selected(g, torch.from_numpy(sel)).numpy()
    assert got.shape == (4, 6, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    dense = solve.marginals(g, exact=True).numpy()[sel]
    np.testing.assert_allclose(got, dense, rtol=0.05, atol=1e-4)
    assert (got[0] == 0).all()  # the fixed node
    assert (np.diagonal(got[1:], axis1=1, axis2=2) > 0).all()


def test_live_node_marginals_equal_the_full_capacity_solve():
    """The builder solves the live nodes' 6n right-hand sides on the live
    part of the graph; the JAX package solves 6 x capacity of them on the
    whole graph. Same values, and zeros past the live nodes."""
    jgs = _loop_graph(n=20, cap=32)
    cfg = OptimizerConfig(solver_backend="dense", per_tick_marginals="cg")
    gs = _port_builder(jgs, cfg, 32, 64)
    gs.optimize()
    assert gs.last_marginals.shape == (20, 6, 6)
    g = gs.snapshot()
    full = solve.marginals_selected(g, torch.arange(32)).numpy()
    scale = np.abs(full).max()
    assert np.abs(gs.last_marginals - full[:20]).max() <= 1e-6 * scale
    assert (full[20:] == 0).all()


def test_default_capacity_marginals_route_to_cg():
    """ROADMAP fault 3.1: at a capacity past 4096 dofs the default "auto"
    marginals are cg, which the port once refused, so every tick raised.
    A store of capacity 1024 optimizes, and its marginals are the exact
    dense blocks of the same graph at capacity 64."""
    jgs = _loop_graph(n=40, cap=64)
    cfg = OptimizerConfig(solver_backend="cg", g2o_solver_num_iterations=64)
    assert cfg.per_tick_marginals == "auto"
    assert solve.resolve_marginals_mode("auto", 1024) == "cg"
    big = _port_builder(jgs, cfg, 1024, 2048)
    big.optimize()
    assert big.last_marginals.shape == (40, 6, 6)
    assert big.last_marginals_ms > 0 and big.last_lm_ms > 0
    small = _port_builder(jgs, cfg, 64, 128)
    small._poses[:40] = big.poses
    exact = small.compute_marginals(exact=True)
    np.testing.assert_allclose(big.last_marginals, exact, rtol=0.05,
                               atol=1e-4)
    assert (big.last_marginals[0] == 0).all()


def _exact64(g, ridge=1e-6):
    """Diagonal blocks of (H + ridge I)^-1 over the free dofs, H
    assembled and inverted in float64 from the float32 linearization; 1e-6
    is the ridge of the system the cg marginals solve."""
    lin = solve.linearize(g)
    n = g.n_nodes
    H = torch.zeros(6 * n, 6 * n, dtype=torch.float64)
    ar = torch.arange(6)
    ends = ((g.se3.from_idx.long(), lin.Ji.double()),
            (g.se3.to_idx.long(), lin.Jj.double()))
    for ia, Ja in ends:
        for ib, Jb in ends:
            H.index_put_((ia[:, None, None] * 6 + ar[:, None],
                          ib[:, None, None] * 6 + ar),
                         Ja.transpose(1, 2) @ lin.W_se3.double() @ Jb,
                         accumulate=True)
    fn, _ = solve._free_masks(g)
    idx = torch.nonzero(fn[:, 0].bool().repeat_interleave(6))[:, 0]
    inv = torch.zeros_like(H)
    inv[idx[:, None], idx[None, :]] = torch.linalg.inv(
        H[idx][:, idx] + ridge * torch.eye(len(idx), dtype=torch.float64))
    return inv.view(n, 6, n, 6).diagonal(dim1=0, dim2=2).permute(
        2, 0, 1).numpy()


def _slam_like(n=96, laps=1.51, seed=0):
    """A keyframe graph shaped like full SLAM's: n keyframes over 1.5
    laps of a 20 m circle, noisy odometry from a fixed first node, and
    Huber loop edges between keyframes within 2 m on later laps,
    optimized."""
    from mrg_slam_tpu_torch.utils import se3 as tse3
    from mrg_slam_tpu_torch.utils import se3np

    rng = np.random.default_rng(seed)
    th = laps * 2 * np.pi * np.arange(n) / n
    gt = tse3.pose_exp(torch.from_numpy(np.stack(
        [20 * np.cos(th), 20 * np.sin(th), 0 * th, 0 * th, 0 * th,
         th + np.pi / 2], 1).astype(np.float32))).numpy()
    info = _info(0.05, 0.01)
    gs = builder.GraphSLAM(OptimizerConfig(solver_backend="dense",
                                           per_tick_marginals="none"),
                           capacity_nodes=n, capacity_edges=2 * n,
                           device="cpu")
    est = gt[0]
    gs.add_se3_node(est, fixed=True)
    for i in range(1, n):
        rel = se3np.pose_between(gt[i - 1], gt[i])
        rel[:3] += rng.normal(scale=0.02, size=3).astype(np.float32)
        est = se3np.pose_compose(est, rel)
        gs.add_se3_node(est)
        gs.add_se3_edge(i - 1, i, rel, info)
    for i in range(n):
        for j in range(i + int(0.6 * n / laps), n):
            if (np.linalg.norm(gt[i][:3] - gt[j][:3]) < 2.0
                    and rng.random() < 0.5):
                gs.add_se3_edge(i, j, se3np.pose_between(gt[i], gt[j]),
                                info, kernel="Huber")
    gs.optimize()
    return gs


def test_marginals_selected_runs_cg_to_the_system_size():
    """On a full-SLAM-shaped graph the JAX package's fixed 400 CG
    iterations stop short of the marginals (ROADMAP.md §3 B6); the port's
    default cap, the system's size 6N, reaches them at the JAX package's
    bar (rtol 0.05, atol 1e-4) against the float64 inverse of the system
    they solve."""
    g = _slam_like().snapshot()
    sel = torch.tensor([24, 48, 72, 95])
    want = _exact64(g)[sel.numpy()]
    got = solve.marginals_selected(g, sel).numpy()
    np.testing.assert_allclose(got, want, rtol=0.05, atol=1e-4)
    short = solve.marginals_selected(g, sel, cg_max=400).numpy()
    assert (np.abs(short - want) > 1e-4 + 0.05 * np.abs(want)).any()
