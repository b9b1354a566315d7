"""The port's pose-graph solver against the JAX package's, on the same
graphs (built with numpy from a seed, carried across with
`convert.graph_from_numpy`).

Tolerances and why:
- se3_edge_terms: residuals and Jacobians within 1e-5. The JAX package
  differentiates the residual in float32 with `jax.jacfwd`; the port
  forms the same derivative in closed form in float64 and rounds once, so
  the two differ by the float32 rounding of the autodiff chain (a few
  1e-6 on entries up to ~10).
- dense optimize: chi2 before and after within rel 1e-3, poses within
  the ROADMAP's 1.0 m solver bound (on this ring within 1e-2 m: the
  rounding-noise tail below moves the poses by a few mm).
  Both packages factor an equilibrated float32 Hessian, JAX the upper
  Cholesky factor and the port the lower one, so the steps round
  differently. Iterations within 2, with LM stopping at a relative chi2
  gain of 1e-4: at the default 1e-6 the last iterations of both packages
  sit on chi2's float32 rounding floor (~1e-6 relative here), where
  accepting or rejecting a step is rounding noise, and the two stop a
  few iterations apart at the same chi2.
- marginals: exact=True within rel 1e-3 of the largest entry of a
  float64 inverse of the same dense Hessian (tests/test_torch_backend.py
  holds it to the JAX package's); exact=False within rel 1e-3 of float64
  inverses of the Hessian's diagonal blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.config import OptimizerConfig as JOptimizerConfig
from mrg_slam_tpu.graph import builder as jbuilder
from mrg_slam_tpu.graph import edges as jedges
from mrg_slam_tpu.graph import solve as jsolve
from mrg_slam_tpu.graph.types import SE3Edges as JSE3Edges

from mrg_slam_tpu_torch.convert import config_from_fields, graph_from_numpy
from mrg_slam_tpu_torch.graph import builder, edges, solve
from mrg_slam_tpu_torch.graph.types import PoseGraphData, SE3Edges
from mrg_slam_tpu_torch.utils import se3 as tse3
from mrg_slam_tpu_torch.utils import se3np

from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)

JCFG = JOptimizerConfig(solver_backend="dense", g2o_solver_num_iterations=64)
CFG = config_from_fields(dataclasses.asdict(JCFG))


def _info(t_std, r_std):
    return np.diag([1 / t_std ** 2] * 3 + [1 / r_std ** 2] * 3).astype(
        np.float32)


def _exp(xi):
    return tse3.pose_exp(torch.tensor(xi, dtype=torch.float32)).numpy()


def _ring(n=30, seed=0):
    """A 30-node ring: noisy odometry chain from a fixed first node, loop
    edges with a Huber kernel (one of them an outlier), in the JAX
    package's builder with zero-capacity aux tables, as the back end
    builds its graphs."""
    rng = np.random.default_rng(seed)
    gs = jbuilder.GraphSLAM(JCFG, capacity_nodes=32, capacity_edges=64,
                            capacity_planes=0, capacity_priors=0,
                            capacity_plane_edges=0, capacity_plane_priors=0,
                            capacity_plane_plane=0)
    gt = [_exp([10 * np.cos(t), 10 * np.sin(t), 0.1 * np.sin(3 * t), 0, 0,
                t]) for t in 2 * np.pi * np.arange(n) / n]
    est = [gt[0]]
    gs.add_se3_node(gt[0], fixed=True)
    for i in range(1, n):
        rel = se3np.pose_compose(se3np.pose_between(gt[i - 1], gt[i]),
                                 _exp(rng.normal(scale=0.03, size=6)))
        est.append(se3np.pose_compose(est[-1], rel))
        gs.add_se3_node(est[-1])
        gs.add_se3_edge(i - 1, i, rel, _info(0.1, 0.05))
    for a, b in ((n - 1, 0), (n - 2, 1), (n // 2, 3)):
        rel = se3np.pose_between(gt[a], gt[b])
        if (a, b) == (n // 2, 3):  # an outlier the kernel must damp
            rel = se3np.pose_compose(rel, _exp([2.0, -1.0, 0, 0, 0, 0.3]))
        gs.add_se3_edge(a, b, rel, _info(0.05, 0.02), kernel="Huber",
                        kernel_delta=1.0)
    return gs


@pytest.fixture(scope="module")
def ring():
    gs = _ring()
    g = gs.snapshot()
    g_np = jax.tree.map(np.asarray, g)
    res = jsolve.optimize(g, JCFG)
    return dict(g=g_np, poses=np.asarray(res.poses),
                chi2=(float(res.chi2_initial), float(res.chi2_final)),
                iters=int(res.iterations), n=gs.num_nodes)


def _port(ring_):
    return graph_from_numpy(ring_["g"], device="cpu")


def test_graph_from_numpy_carries_every_field(ring):
    g = _port(ring)
    assert isinstance(g, PoseGraphData) and isinstance(g.se3, SE3Edges)
    np.testing.assert_array_equal(g.poses.numpy(), ring["g"].poses)
    np.testing.assert_array_equal(g.se3.from_idx.numpy(),
                                  ring["g"].se3.from_idx)
    assert g.se3.from_idx.dtype == torch.int32
    assert g.priors.mask.shape == (0,) and g.planes.shape == (0, 4)


def test_se3_edge_terms_match_jax(ring):
    rng = np.random.default_rng(1)
    g = ring["g"]
    # the ring's edges, then edges far from consistent and self-edges
    e = g.se3.mask.sum()
    fi = np.concatenate([g.se3.from_idx[:e], rng.integers(0, 30, 16), [4]])
    ti = np.concatenate([g.se3.to_idx[:e], rng.integers(0, 30, 16), [4]])
    meas = np.concatenate([g.se3.meas[:e], np.stack(
        [_exp(rng.normal(scale=0.8, size=6)) for _ in range(16)]),
        [[0, 0, 0, 1, 0, 0, 0]]]).astype(np.float32)
    poses = g.poses
    jt = JSE3Edges.empty(len(fi))._replace(
        from_idx=jnp.asarray(fi, jnp.int32), to_idx=jnp.asarray(ti, jnp.int32),
        meas=jnp.asarray(meas))
    want = [np.asarray(a) for a in jax.jit(jedges.se3_edge_terms)(
        jnp.asarray(poses), jt)]
    tt = SE3Edges.empty(len(fi))._replace(
        from_idx=torch.from_numpy(fi.astype(np.int32)),
        to_idx=torch.from_numpy(ti.astype(np.int32)),
        meas=torch.from_numpy(meas))
    got = edges.se3_edge_terms(torch.from_numpy(np.array(poses)), tt)
    for w, t in zip(want, got):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-5)


def test_dense_optimize_matches_jax(ring):
    g = _port(ring)
    res = solve.optimize(g, CFG)
    c0, c1 = ring["chi2"]
    assert c1 < 0.2 * c0  # the loops pulled the chain in
    np.testing.assert_allclose(float(res.chi2_initial), c0, rtol=1e-3)
    np.testing.assert_allclose(float(res.chi2_final), c1, rtol=1e-3)
    coarse = dataclasses.replace(JCFG, chi2_rel_tol=1e-4)
    want = jsolve.optimize(jax.tree.map(jnp.asarray, ring["g"]), coarse)
    got = solve.optimize(g, config_from_fields(dataclasses.asdict(coarse)))
    assert abs(got.iterations - int(want.iterations)) <= 2
    np.testing.assert_allclose(float(got.chi2_final),
                               float(want.chi2_final), rtol=1e-3)
    n = ring["n"]
    d = np.abs(res.poses.numpy()[:n, :3] - ring["poses"][:n, :3]).max()
    assert d < 1.0 and d < 1e-2, d
    # the fixed node and the padding lanes do not move
    np.testing.assert_array_equal(res.poses.numpy()[0], ring["g"].poses[0])
    np.testing.assert_array_equal(res.poses.numpy()[n:],
                                  ring["g"].poses[n:])


def test_marginals_match_dense_inverse(ring):
    """exact=True: the 6x6 diagonal blocks of a float64 inverse of the
    dense Hessian (tests/test_torch_backend.py holds them to the JAX
    package); exact=False: the inverses of its diagonal blocks."""
    g = _port(ring)
    g = g._replace(poses=torch.from_numpy(ring["poses"].copy()))
    n = ring["n"]
    H, _, _ = solve.assemble_dense(g, solve.linearize(g))
    H = H.numpy().astype(np.float64)
    cov = solve.marginals(g, exact=True).numpy()
    assert cov.shape == (32, 6, 6)
    hinv = np.linalg.inv(H + 1e-9 * np.eye(H.shape[0]))
    want = np.stack([hinv[6 * i:6 * i + 6, 6 * i:6 * i + 6]
                     for i in range(1, n)])
    assert np.abs(cov[1:n] - want).max() <= 1e-3 * np.abs(want).max()
    assert (cov[0] == 0).all()  # the fixed node
    assert (cov[n:] == 0).all()  # padding
    # block-Jacobi: the inverse of each free node's diagonal 6x6 block of
    # the dense Hessian (plus the 1e-6 ridge)
    approx = solve.marginals(g, exact=False).numpy()
    for i in range(1, n):
        blk = H[6 * i:6 * i + 6, 6 * i:6 * i + 6] + 1e-6 * np.eye(6)
        np.testing.assert_allclose(approx[i], np.linalg.inv(blk),
                                   rtol=1e-3, atol=1e-6)
    assert (approx[0] == 0).all() and (approx[n:] == 0).all()


def test_builder_solves_and_reads_back_once(ring):
    jgs = _ring()
    gs = builder.GraphSLAM(CFG, capacity_nodes=4, capacity_edges=4,
                           device="cpu")
    n = jgs.num_nodes
    for i in range(n):
        gs.add_se3_node(jgs.poses[i], fixed=bool(jgs.fixed[i]))
    kernels = {v: k for k, v in builder.KERNEL_IDS.items()}
    a = jgs._se3.arrays
    for e in range(jgs.num_edges):
        gs.add_se3_edge(int(a["from_idx"][e]), int(a["to_idx"][e]),
                        a["meas"][e], a["info"][e],
                        kernel=kernels[int(a["kernel"][e])],
                        kernel_delta=float(a["delta"][e]))
    # 4 doubled three times; the prior and plane tables hold nothing
    assert gs.cap == dict(nodes=32, edges=32, planes=0, priors=0,
                          plane_edges=0, plane_priors=0, plane_plane=0)
    gs.optimize()
    np.testing.assert_allclose(gs.chi2_final, ring["chi2"][1], rtol=1e-3)
    assert np.abs(gs.poses[:, :3] - ring["poses"][:n, :3]).max() < 1e-2
    assert gs.last_marginals.shape == (n, 6, 6)  # auto -> exact
    assert (gs.last_marginals[1:, :3, :3].diagonal(0, 1, 2) > 0).all()


def test_np_table_grow_doubles_and_keeps_rows():
    t = builder._NpTable(2, {"a": ((), np.int32, -1),
                             "m": ((7,), np.float32, builder._POSE_ID)})
    for i in range(5):
        assert t.add(a=i, m=np.full(7, i, np.float32)) == i
    assert t.capacity == 8 and len(t) == 5
    np.testing.assert_array_equal(t.arrays["a"], [0, 1, 2, 3, 4, -1, -1, -1])
    np.testing.assert_array_equal(t.arrays["m"][4], np.full(7, 4))
    np.testing.assert_array_equal(t.arrays["m"][5], builder._POSE_ID)
    np.testing.assert_array_equal(t.mask(), [1] * 5 + [0] * 3)
    t.grow(4)  # never shrinks
    assert t.capacity == 8
    t.grow(20)
    assert t.capacity == 20 and t.arrays["a"][19] == -1


def test_unported_solvers_and_families_raise(ring):
    """The large-graph solvers resolve (ROADMAP item 13, once refused
    here), and so do the prior and plane families (item 12, once refused
    here): a live XYZ prior on the ring reaches the JAX package's chi2
    within rel 1e-3."""
    g = _port(ring)
    for backend in ("cg", "chain"):
        res = solve.optimize(g, dataclasses.replace(
            CFG, solver_backend=backend))
        np.testing.assert_allclose(float(res.chi2_final), ring["chi2"][1],
                                   rtol=1e-3)
    assert solve.resolve_backend("auto", 2048) == "dense"
    assert solve.resolve_backend("auto", 2049) == "chain"
    assert solve.resolve_backend("auto", 4096) == "chain"
    assert solve.resolve_backend("cg", 8192) == "cg"
    with pytest.raises(ValueError):
        solve.resolve_backend("cholmod", 64)
    assert solve.resolve_marginals_mode("auto", 512) == "exact"
    assert solve.resolve_marginals_mode("auto", 1024) == "cg"
    assert solve.resolve_marginals_mode("auto", 2048) == "cg"
    # an empty prior table changes nothing; a live prior (ported since
    # item 12, once refused here) is solved as the JAX package solves it
    spare = PoseGraphData.empty(32, 64, n_priors=4)
    g2 = g._replace(priors=spare.priors)
    np.testing.assert_allclose(float(solve.optimize(g2, CFG).chi2_final),
                               ring["chi2"][1], rtol=1e-3)
    from mrg_slam_tpu.graph.types import PriorEdges as JPriorEdges
    meas = np.zeros((4, 8), np.float32)
    meas[0, :3] = ring["poses"][5, :3] + [0.5, -0.3, 0.2]
    info = np.zeros((4, 3, 3), np.float32)
    info[0] = np.eye(3) * 50.0
    prior = JPriorEdges(node_idx=np.asarray([5, 0, 0, 0], np.int32),
                        ptype=np.zeros(4, np.int32), meas=meas, info=info,
                        kernel=np.zeros(4, np.int32),
                        delta=np.ones(4, np.float32),
                        mask=np.asarray([True, False, False, False]))
    g_np = ring["g"]._replace(priors=prior)
    want = jsolve.optimize(jax.tree.map(jnp.asarray, g_np), JCFG)
    got = solve.optimize(graph_from_numpy(g_np, device="cpu"), CFG)
    assert float(want.chi2_final) > ring["chi2"][1] + 1.0  # it pulls
    np.testing.assert_allclose(float(got.chi2_final),
                               float(want.chi2_final), rtol=1e-3)
