"""The port's prior, SE3-plane, plane-prior and plane-plane families
(graph/edges.py, graph/solve.py, graph/chain_solver.py, graph/builder.py)
against the JAX package, on the same numpy inputs.

Tolerances and why:
- residuals and Jacobians at random poses and planes: within abs 1e-5
  and rel 1e-4 of the JAX package's `jax.jacfwd` (the port's closed
  forms are the same derivatives; float32 rounds them otherwise).
- the family graph (`baseline_runs.family_graph_spec(32)`, every
  family on one ring) after 40 LM iterations: chi2 within rel 1e-3 of
  the JAX package's dense solve for each of the port's dense, cg and
  chain backends (the ROADMAP's solver gate; the JAX package's three
  backends agree within 2e-6 on this spec at 256 nodes,
  tools/floor_reference.py), and the planes within 1e-3.
- tests/test_plane_edges.py's cases: its own bars (1e-2 on the planes),
  and the JAX package's planes within 1e-3 for the dense backend.
- marginals with a plane pool: each path against the float64 inverse of
  its own system, H + 1e-9 I (dense, within 1e-3 of the largest entry:
  a float32 Cholesky inverse) or H + 1e-6 I (cg, the JAX package's bar
  rtol 0.05 + atol 1e-4; chain, float64 throughout, within 1e-6 of the
  largest entry).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.config import OptimizerConfig as JOptimizerConfig
from mrg_slam_tpu.graph import edges as jedges
from mrg_slam_tpu.graph import types as jtypes
from mrg_slam_tpu.graph.builder import GraphSLAM as JGraphSLAM

from mrg_slam_tpu_torch.config import OptimizerConfig
from mrg_slam_tpu_torch.graph import chain_solver, edges, solve, types
from mrg_slam_tpu_torch.graph.builder import GraphSLAM
from mrg_slam_tpu_torch.pipeline.baseline_runs import (
    family_graph_capacities, family_graph_spec, fill_family_graph)

from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)

E = 48


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    poses = np.concatenate([rng.uniform(-40, 40, (E, 3)), _quats(rng, E)],
                           1).astype(np.float32)
    n = rng.normal(size=(E, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    # every plane basis branch: normals near +-x (|n_x| >= 0.9) too
    n[:4] = [[1, 0, 0], [-1, 0.01, 0], [0.95, 0.3, 0.1], [0, 0, 1]]
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    planes = np.concatenate([n, rng.uniform(-10, 10, (E, 1))],
                            1).astype(np.float32)
    meas8 = rng.normal(size=(E, 8)).astype(np.float32)
    meas8[:, :4] = _quats(rng, E)
    meas8[::5, :4] = poses[::5, 3:7]  # sign-aligned quaternion priors
    meas8[1::5, :4] = -poses[1::5, 3:7]  # and flipped ones
    m4 = np.concatenate([_quats(rng, E)[:, :3], rng.normal(size=(E, 1))], 1)
    m4[:, :3] /= np.linalg.norm(m4[:, :3], axis=1, keepdims=True)
    return dict(poses=poses, planes=planes, meas8=meas8,
                meas4=m4.astype(np.float32), ptype3=np.arange(E) % 3,
                ptype2=np.arange(E) % 2, idx=np.arange(E),
                idx2=rng.permutation(E))


def _common(n, jx):
    if jx:
        return dict(kernel=jnp.zeros(n, jnp.int32), delta=jnp.ones(n),
                    mask=jnp.ones(n, bool))
    return dict(kernel=torch.zeros(n, dtype=torch.int32),
                delta=torch.ones(n), mask=torch.ones(n, dtype=torch.bool))


def _tables(x, jx):
    """The four families' tables over the inputs, in either package."""
    T = jtypes if jx else types
    cv = (lambda a, dt=np.float32: jnp.asarray(np.asarray(a, dt))) if jx \
        else (lambda a, dt=np.float32: torch.from_numpy(np.asarray(a, dt)))
    i32 = np.int32
    idx, idx2 = cv(x["idx"], i32), cv(x["idx2"], i32)
    com = _common(E, jx)
    return dict(
        priors=T.PriorEdges(idx, cv(x["ptype3"], i32), cv(x["meas8"]),
                            cv(np.zeros((E, 3, 3))), **com),
        plane_edges=T.PlaneEdges(idx, idx2, cv(x["meas4"]),
                                 cv(np.zeros((E, 3, 3))), **com),
        plane_priors=T.PlanePriorEdges(idx, cv(x["ptype2"], i32),
                                       cv(x["meas4"]),
                                       cv(np.zeros((E, 4, 4))), **com),
        plane_plane=T.PlanePlaneEdges(idx, idx2, cv(x["ptype3"], i32),
                                      cv(x["meas4"]),
                                      cv(np.zeros((E, 4, 4))), **com),
        poses=cv(x["poses"]), planes=cv(x["planes"]))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("family", ["priors", "plane_edges", "plane_priors",
                                    "plane_plane"])
def test_family_terms_match_jax_jacfwd(inputs, family):
    j, t = _tables(inputs, True), _tables(inputs, False)
    fn = dict(priors=(jedges.prior_edge_terms, edges.prior_edge_terms, 0),
              plane_edges=(jedges.plane_edge_terms, edges.plane_edge_terms,
                           1),
              plane_priors=(jedges.plane_prior_terms,
                            edges.plane_prior_terms, 2),
              plane_plane=(jedges.plane_plane_terms,
                           edges.plane_plane_terms, 2))[family]
    args = {0: ("poses",), 1: ("poses", "planes"), 2: ("planes",)}[fn[2]]
    want = jax.jit(fn[0])(*(j[a] for a in args), j[family])
    got = fn[1](*(t[a] for a in args), t[family])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w)


def test_plane_chart_matches_jax(inputs):
    d = np.random.default_rng(1).normal(scale=0.2, size=(E, 3))
    d = d.astype(np.float32)
    _close(types.plane_retract(torch.from_numpy(inputs["planes"]),
                               torch.from_numpy(d)).numpy(),
           jtypes.plane_retract(jnp.asarray(inputs["planes"]),
                                jnp.asarray(d)))
    _close(edges.transform_plane(torch.from_numpy(inputs["poses"]),
                                 torch.from_numpy(inputs["planes"])).numpy(),
           jedges.transform_plane(jnp.asarray(inputs["poses"]),
                                  jnp.asarray(inputs["planes"])))


ITERS = 40


def _family(backend, jx=False, n=32):
    spec = family_graph_spec(n, 0)
    cfg = dict(solver_backend=backend, g2o_solver_num_iterations=ITERS,
               per_tick_marginals="none")
    if jx:
        gs = JGraphSLAM(JOptimizerConfig(**cfg),
                        **family_graph_capacities(spec))
    else:
        gs = GraphSLAM(OptimizerConfig(**cfg), device="cpu",
                       **family_graph_capacities(spec))
    return fill_family_graph(gs, spec)


@pytest.fixture(scope="module")
def jax_family():
    gs = _family("dense", jx=True)
    gs.optimize()
    return gs


@pytest.mark.parametrize("backend", ["dense", "cg", "chain"])
def test_family_graph_solves_to_the_jax_chi2(jax_family, backend):
    gs = _family(backend)
    assert gs.cap["priors"] > 0 and gs.cap["plane_plane"] == 3
    gs.optimize()
    assert gs.chi2_initial > 100 * gs.chi2_final
    np.testing.assert_allclose(gs.chi2_initial, jax_family.chi2_initial,
                               rtol=1e-5)
    np.testing.assert_allclose(gs.chi2_final, jax_family.chi2_final,
                               rtol=1e-3)
    np.testing.assert_allclose(gs.planes, jax_family.planes, atol=1e-3)
    # the fixed floor plane stays put
    np.testing.assert_array_equal(gs.planes[0], [0, 0, 1, 0])


def _plane_cases(make, backends=("dense", "cg")):
    """tests/test_plane_edges.py's graphs, in `make(backend)`'s builder."""
    out = {}
    for backend in backends:
        gs = make(backend)
        p = gs.add_plane_node([0.3, 0.0, 0.95, 0.0])
        gs.add_plane_prior_normal_edge(p, [0, 0, 1], np.eye(3) * 100)
        gs.add_plane_prior_distance_edge(p, -2.0, 100.0)
        out["prior_" + backend] = gs
    gs = make("dense")
    a = gs.add_plane_node([0, 0, 1, 0], fixed=True)
    gs.add_plane_node([0.2, 0, 0.98, 0.5])
    gs.add_plane_identity_edge(a, 1, [0, 0, 0, 0], np.eye(4) * 100)
    out["identity"] = gs
    gs = make("dense")
    gs.add_plane_node([0, 0, 1, 0], fixed=True)
    gs.add_plane_node([0.3, 0.1, 0.95, 1.0])
    gs.add_plane_parallel_edge(0, 1, [0, 0, 0], np.eye(3) * 100)
    out["parallel"] = gs
    gs = make("dense")
    gs.add_plane_node([0, 0, 1, 0], fixed=True)
    gs.add_plane_node([0.7, 0.0, 0.714, 0.0])
    gs.add_plane_perpendicular_edge(0, 1, meas_dot=0.0, info1=100.0)
    out["perpendicular"] = gs
    for gs in out.values():
        gs.optimize()
    return out


def test_plane_edge_cases_of_the_jax_package(jax_family):
    """tests/test_plane_edges.py's four cases (the prior on both
    backends) with its bars, and the planes of the dense solves against
    the JAX package's. Both builders take the family graph's capacities
    (the JAX test's defaults hold nothing more here), so that the JAX
    package reuses the dense program the `jax_family` fixture compiled."""
    caps = family_graph_capacities(family_graph_spec(32, 0))
    got = _plane_cases(lambda b: GraphSLAM(
        OptimizerConfig(solver_backend=b), device="cpu", **caps))
    np.testing.assert_allclose(got["prior_cg"].planes[0][:3], [0, 0, 1],
                               atol=1e-2)
    for key in ("prior_dense", "prior_cg"):
        np.testing.assert_allclose(got[key].planes[0][:3], [0, 0, 1],
                                   atol=1e-2)
        np.testing.assert_allclose(got[key].planes[0][3], -2.0, atol=1e-2)
    np.testing.assert_allclose(got["identity"].planes[1],
                               got["identity"].planes[0], atol=1e-2)
    np.testing.assert_allclose(got["parallel"].planes[1][:3], [0, 0, 1],
                               atol=1e-2)
    np.testing.assert_allclose(got["parallel"].planes[1][3], 1.0, atol=5e-3)
    pp = got["perpendicular"].planes
    assert abs(float(np.dot(pp[0][:3], pp[1][:3]))) < 0.05
    want = _plane_cases(lambda b: JGraphSLAM(
        JOptimizerConfig(solver_backend=b, per_tick_marginals="none"),
        **caps), backends=("dense",))
    for key in ("prior_dense", "identity", "parallel", "perpendicular"):
        np.testing.assert_allclose(got[key].planes, want[key].planes,
                                   atol=1e-3)


def _inverse64(g, ridge):
    """Diagonal 6x6 node blocks of (H + ridge I)^-1 over the free dofs,
    H assembled in float64 from the float32 linearization."""
    lin = solve.linearize(g)
    lin = solve.LinearizedGraph(*(a if a is None else a.double()
                                  for a in lin))
    H, _, free = solve.assemble_dense(g._replace(poses=g.poses.double()),
                                      lin)
    keep = free.bool()
    Hinv = torch.zeros_like(H)
    Hk = H[keep][:, keep] + ridge * torch.eye(int(keep.sum()),
                                              dtype=H.dtype)
    Hinv[keep.nonzero()[:, 0][:, None], keep.nonzero()[:, 0]] = \
        torch.linalg.inv(Hk)
    n = g.n_nodes
    return Hinv[:6 * n, :6 * n].reshape(n, 6, n, 6).diagonal(
        dim1=0, dim2=2).permute(2, 0, 1)


def test_marginals_with_planes_match_the_float64_inverse():
    gs = _family("dense")
    gs.optimize()
    g = gs.snapshot()
    n = gs.num_nodes
    exact = solve.marginals(g, exact=True)
    want9 = _inverse64(g, 1e-9)
    scale = float(want9.abs().max())
    assert float((exact.double() - want9).abs().max()) <= 1e-3 * scale
    want6 = _inverse64(g, 1e-6)
    cg = solve.marginals_selected(g, torch.arange(n))
    np.testing.assert_allclose(cg.double().numpy(), want6.numpy(),
                               rtol=0.05, atol=1e-4)
    chain = chain_solver.chain_marginals(g, solve.chain_aux_for(g),
                                         solve._chain_K(n))
    scale6 = float(want6.abs().max())
    assert float((chain.double() - want6).abs().max()) <= 1e-6 * scale6
    # the fixed first node has none
    assert (exact[0] == 0).all() and (chain[0] == 0).all()


def test_builder_tables_grow_and_match_jax():
    """Each table doubles from capacity 0; the staging rows equal the
    JAX package's for the same calls."""
    spec = family_graph_spec(16, 1)
    got = fill_family_graph(GraphSLAM(device="cpu", capacity_nodes=16,
                                      capacity_edges=16), spec)
    want = fill_family_graph(JGraphSLAM(capacity_nodes=16,
                                        capacity_edges=16), spec)
    assert got.cap["priors"] == 16 and got.cap["planes"] == 4
    assert got.num_plane_edges == want.num_plane_edges == 16
    for name in ("_priors", "_pl_edges", "_pl_priors", "_pl_pl"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.n == b.n
        for k in a.arrays:
            np.testing.assert_array_equal(a.arrays[k][:a.n],
                                          b.arrays[k][:b.n])
    np.testing.assert_array_equal(got.planes, want.planes)
    snap = got.snapshot()
    assert snap.plane_mask.tolist() == [True] * 3 + [False]
    assert snap.plane_fixed.tolist() == [True] + [False] * 3
    assert int(snap.priors.mask.sum()) == got._priors.n
    live = got._live(snap)
    assert live.planes.shape == (3, 4)
    assert live.plane_plane.mask.shape == (3,)
    np.testing.assert_allclose(float(solve.chi2_only(snap)),
                               float(solve.linearize(snap).chi2), rtol=1e-6)
