"""The port's chain backend (graph/chain_solver.py: segmented
block-tridiagonal Cholesky + Woodbury) against the JAX package's and
against the port's dense solves, on the SE3 families (the prior and plane
families are item 12 and stay refused).

Tolerances and why:
- classify and _bucket: equal arrays (pure numpy on both sides).
- one chain step against the port's dense step, and against the JAX
  package's chain step on the same graph: the JAX package's own bar
  (tests/test_chain_solver.py::test_chain_step_matches_dense_step):
  dx within 1e-4 of max(|dx|, 1), predicted reduction rel 1e-3.
- chain LM at 256 nodes against the JAX package's chain LM and the port's
  dense LM: chi2 after within rel 1e-3 (the ROADMAP's solver gate).
- chain marginals against the port's dense inverse at 256 nodes: the JAX
  package's bar (test_chain_marginals_match_dense: atol 0.02 of the
  largest entry, rtol 0.05). Against the exact float64 inverse of the
  chain path's own system, H + 1e-6 I on the free dofs: within 1e-5 of
  the largest entry. The port computes them in float64 because the JAX
  package's float32 form cancels most of an open chain's T^-1 (ROADMAP.md
  §3 B5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.config import OptimizerConfig as JOptimizerConfig
from mrg_slam_tpu.graph import chain_solver as jchain
from mrg_slam_tpu.graph import solve as jsolve
from mrg_slam_tpu.graph.builder import GraphSLAM as JGraphSLAM
from mrg_slam_tpu.utils import se3np as jse3np

from mrg_slam_tpu_torch.config import OptimizerConfig
from mrg_slam_tpu_torch.convert import graph_from_numpy
from mrg_slam_tpu_torch.graph import builder, chain_solver, solve


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_graph(n=64, seed=0, chord_every=7):
    """tests/test_chain_solver.py's build_mixed_graph without its prior
    and plane families: a noisy ring of n nodes, Huber odometry edges and
    Cauchy chords across it, node 0 fixed, in the JAX package's builder
    with zero-capacity aux tables."""
    rng = np.random.default_rng(seed)
    gs = JGraphSLAM(JOptimizerConfig(), capacity_nodes=n,
                    capacity_edges=2 * n, capacity_planes=0,
                    capacity_priors=0, capacity_plane_edges=0,
                    capacity_plane_priors=0, capacity_plane_plane=0)
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    poses = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        p = np.asarray([15 * np.cos(ang), 15 * np.sin(ang),
                        0.05 * rng.normal(),
                        *jse3np.rpy_to_quat(0, 0, ang)], np.float32)
        p[:3] += 0.1 * rng.normal(size=3)
        poses.append(p)
        gs.add_se3_node(p, fixed=(i == 0))
    for i in range(1, n):
        rel = jse3np.pose_between(poses[i - 1], poses[i])
        rel[:3] += 0.05 * rng.normal(size=3).astype(np.float32)
        gs.add_se3_edge(i - 1, i, rel, info, kernel="Huber",
                        kernel_delta=2.0)
    for i in range(0, n - n // 2, chord_every):
        j = i + n // 2
        gs.add_se3_edge(i, j, jse3np.pose_between(poses[i], poses[j]),
                        info * 0.3, kernel="Cauchy", kernel_delta=1.0)
    return gs


def _aux(gs):
    a = gs._se3.arrays
    return jchain.classify(a["from_idx"], a["to_idx"], gs._se3.mask(), 0, 0,
                           pl_mask=gs._pl_edges.mask(),
                           qq_mask=gs._pl_pl.mask())


def _port(jgs):
    return graph_from_numpy(jax.tree.map(np.asarray, jgs.snapshot()),
                            device="cpu")


def test_classify_and_bucket_match_jax():
    for n in list(range(0, 40)) + [64, 65, 80, 81, 200]:
        assert chain_solver._bucket(n) == jchain._bucket(n)
        assert chain_solver._bucket(n, lo=1) == jchain._bucket(n, lo=1)
    rng = np.random.default_rng(3)
    f = rng.integers(0, 50, 120).astype(np.int32)
    t = np.where(rng.random(120) < 0.7, f + 1, rng.integers(0, 50, 120))
    t = t.astype(np.int32)
    t[:3] = f[:3]  # self-edges couple
    mask = rng.random(120) < 0.8
    pl_mask, qq_mask = rng.random(20) < 0.5, np.zeros(6, bool)
    for args, kw in (((f, t, mask, 20, 6), dict(pl_mask=pl_mask,
                                                 qq_mask=qq_mask)),
                     ((f, t, mask, 0, 0), {}), ((f, t, mask, 7, 33), {})):
        want = jchain.classify(*args, **kw)
        got = chain_solver.classify(*args, **kw)
        for w, g in zip(want, got):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, np.asarray(w))


@functools.partial(jax.jit, static_argnames=("K",))
def _jax_chain_delta(g, lam, aux, K):
    return jchain.chain_delta(g, jsolve.linearize(g), lam, aux, K)


@pytest.mark.parametrize("K", [8, 16, 64])
def test_chain_step_matches_dense_step_and_jax(K):
    jgs = _mixed_graph()
    g = _port(jgs)
    lam = 1e-3
    lin = solve.linearize(g)
    H, b, free = solve.assemble_dense(g, lin)
    x_dense, pred_d = solve.dense_delta(H, b, free, torch.tensor(lam))
    a = jgs._se3.arrays
    aux = chain_solver.aux_to(chain_solver.classify(
        a["from_idx"], a["to_idx"], jgs._se3.mask(), 0, 0), "cpu")
    dx, _, pred, ok = chain_solver.chain_delta(g, lin, torch.tensor(lam), aux,
                                               K)
    assert bool(ok)
    n = g.n_nodes
    xd = x_dense[:6 * n].view(n, 6).numpy()
    scale = max(float(np.abs(xd).max()), 1.0)
    np.testing.assert_allclose(dx.numpy(), xd, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(float(pred), float(pred_d), rtol=1e-3)
    jg = jgs.snapshot()
    with jax.default_matmul_precision("highest"):
        jdx, _, jpred, _ = _jax_chain_delta(jg, jnp.float32(lam), _aux(jgs),
                                            K)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(float(pred), float(jpred), rtol=1e-3)


def test_chain_lm_matches_jax_and_dense():
    jgs = _mixed_graph(n=256, chord_every=16)
    jcfg = JOptimizerConfig(solver_backend="chain",
                            g2o_solver_num_iterations=64)
    want = jsolve.optimize(jgs.snapshot(), jcfg)
    g = _port(jgs)
    got = solve.optimize(g, OptimizerConfig(solver_backend="chain",
                                            g2o_solver_num_iterations=64))
    dense = solve.optimize(g, OptimizerConfig(solver_backend="dense",
                                              g2o_solver_num_iterations=64))
    c0 = float(want.chi2_initial)
    assert float(want.chi2_final) < 0.5 * c0
    np.testing.assert_allclose(float(got.chi2_initial), c0, rtol=1e-5)
    np.testing.assert_allclose(float(got.chi2_final),
                               float(want.chi2_final), rtol=1e-3)
    np.testing.assert_allclose(float(got.chi2_final),
                               float(dense.chi2_final), rtol=1e-3)
    np.testing.assert_array_equal(got.poses.numpy()[0],
                                  np.asarray(jgs.poses[0]))


def _exact_blocks(g, ridge):
    """Diagonal blocks of (H + ridge I)^-1 over the free dofs, with H
    assembled and inverted in float64 from the float32 linearization."""
    lin = solve.linearize(g)
    n = g.n_nodes
    H = torch.zeros(6 * n, 6 * n, dtype=torch.float64)
    W = lin.W_se3.double()
    ends = ((g.se3.from_idx.long(), lin.Ji.double()),
            (g.se3.to_idx.long(), lin.Jj.double()))
    ar = torch.arange(6)
    for ia, Ja in ends:
        for ib, Jb in ends:
            H.index_put_(((ia[:, None, None] * 6 + ar[:, None]),
                          (ib[:, None, None] * 6 + ar)),
                         Ja.transpose(1, 2) @ W @ Jb, accumulate=True)
    fn, _ = solve._free_masks(g)
    keep = fn[:, 0].bool().repeat_interleave(6)
    idx = torch.nonzero(keep)[:, 0]
    inv = torch.zeros_like(H)
    inv[idx[:, None], idx[None, :]] = torch.linalg.inv(
        H[idx][:, idx] + ridge * torch.eye(len(idx), dtype=torch.float64))
    return inv.view(n, 6, n, 6).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def test_chain_marginals_match_the_dense_inverse():
    jgs = _mixed_graph(n=256, chord_every=16)
    g = _port(jgs)
    g = g._replace(poses=solve.optimize(g, OptimizerConfig(
        solver_backend="chain", g2o_solver_num_iterations=16)).poses)
    cov = chain_solver.chain_marginals(g, solve.chain_aux_for(g), 64)
    assert cov.shape == (256, 6, 6) and cov.dtype == torch.float32
    assert (cov[0] == 0).all()  # the fixed node
    dense = solve.marginals(g, exact=True)
    scale = float(dense[1:].abs().max())
    np.testing.assert_allclose(cov[1:].numpy(), dense[1:].numpy(),
                               rtol=0.05, atol=0.02 * scale)
    exact = _exact_blocks(g, 1e-6)
    assert float((cov.double() - exact).abs().max()) <= 1e-5 * scale


def test_auto_routes_to_chain_and_its_marginals(monkeypatch):
    """Past auto_dense_max_dofs (set low here) the builder runs the chain
    backend, classifying from its staging buffers, and "cg" marginals
    become the chain factorization's."""
    jgs = _mixed_graph(n=60)
    cfg = OptimizerConfig(auto_dense_max_dofs=6 * 32, per_tick_marginals="cg",
                          g2o_solver_num_iterations=32)
    gs = builder.GraphSLAM(cfg, capacity_nodes=64, capacity_edges=128,
                           device="cpu")
    for i in range(jgs.num_nodes):
        gs.add_se3_node(jgs.poses[i], fixed=bool(jgs.fixed[i]))
    names = {v: k for k, v in builder.KERNEL_IDS.items()}
    a = jgs._se3.arrays
    for e in range(jgs.num_edges):
        gs.add_se3_edge(int(a["from_idx"][e]), int(a["to_idx"][e]),
                        a["meas"][e], a["info"][e],
                        kernel=names[int(a["kernel"][e])],
                        kernel_delta=float(a["delta"][e]))
    calls = []
    for mod, name in ((chain_solver, "chain_delta"),
                      (chain_solver, "chain_marginals"),
                      (solve, "marginals_selected")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a_, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a_, **k))[1])
    gs.optimize()
    assert "chain_delta" in calls and "chain_marginals" in calls
    assert "marginals_selected" not in calls
    dense = builder.GraphSLAM(OptimizerConfig(solver_backend="dense",
                                              g2o_solver_num_iterations=32),
                              capacity_nodes=64, capacity_edges=128,
                              device="cpu")
    dense._poses, dense._node_fixed = gs._poses.copy(), gs._node_fixed.copy()
    dense._n_nodes, dense._se3 = gs._n_nodes, gs._se3
    exact = dense.compute_marginals(exact=True)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(gs.last_marginals, exact, rtol=0.05,
                               atol=0.02 * scale)
