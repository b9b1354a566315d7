"""The port's chordal initialization and ring-graph builder against the
JAX package's.

Tolerances and why:
- chordal_init on the same cold 128-node ring: rotations within 1e-5 of
  the JAX package's (their CG converges), translations within 0.25 m and
  chi2 at the chordal estimate within rel 0.1. The translation solve is
  ill-conditioned (the anchor's 1e4 weight against unit edge weights on
  a long ring) and stops at its 128 float32 CG iterations short of its
  tolerance, so rotation differences of ~1e-7 move its iterate by up to
  0.18 m; the JAX package's own jitted and unjitted runs land 0.18 m
  apart on the 256-node ring. Rotations orthonormal within 1e-4
  (tests/test_graph.py's bar), the fixed node and the padding bit for
  bit. The iteration claim of
  tests/test_graph.py::test_chordal_init_enters_lm_basin is not held:
  the reference fails it (ROADMAP.md §3 B3).
- GraphSLAM.optimize with chordal_init=True: chi2 after within rel 1e-3
  of the JAX package's (the ROADMAP's solver gate).
- build_ring_graph: masks and indices equal, poses within 2e-5 m: the
  two packages' pose_exp round differently by about one float32 step at
  the ring's 20 m radius, and the estimates accumulate those steps along
  the chain (1.3e-5 m at 256 nodes, the largest seen).
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mrg_slam_tpu.graph import chordal as jchordal
from mrg_slam_tpu.pipeline.baseline_runs import build_ring_graph as jring

from mrg_slam_tpu_torch.convert import graph_from_numpy
from mrg_slam_tpu_torch.graph import chordal, solve
from mrg_slam_tpu_torch.pipeline.baseline_runs import build_ring_graph
from mrg_slam_tpu_torch.utils import se3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ring():
    """The JAX package's cold 128-node ring in a store of 256 nodes."""
    return jring(n_nodes=128, capacity_nodes=256, backend="dense",
                 noise_scale=0.05)


def _port_ring():
    return build_ring_graph(n_nodes=128, capacity_nodes=256,
                            backend="dense", noise_scale=0.05, device="cpu")


def test_chordal_init_matches_jax(jax_ring):
    jgs = jax_ring
    jg = jgs.snapshot()
    g = graph_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    want = np.array(jchordal.chordal_init(jg))
    got = chordal.chordal_init(g)
    n = jgs.num_nodes
    np.testing.assert_allclose(got.numpy()[:n, 3:], want[:n, 3:], rtol=0,
                               atol=1e-5)
    assert np.abs(got.numpy()[:n, :3] - want[:n, :3]).max() < 0.25
    chi2_raw = float(solve.chi2_only(g))
    chi2 = float(solve.chi2_only(g._replace(poses=got)))
    assert chi2 < chi2_raw / 50
    chi2_jax = float(solve.chi2_only(g._replace(
        poses=torch.from_numpy(want))))
    np.testing.assert_allclose(chi2, chi2_jax, rtol=0.1)
    R = se3.quat_to_mat(got[:n, 3:7])
    ortho = (R @ R.transpose(1, 2)).numpy()
    np.testing.assert_allclose(ortho, np.broadcast_to(np.eye(3), ortho.shape),
                               atol=1e-4)
    np.testing.assert_array_equal(got.numpy()[0], np.asarray(jg.poses)[0])
    np.testing.assert_array_equal(got.numpy()[n:], np.asarray(jg.poses)[n:])


def test_project_so3_matches_jax():
    rng = np.random.default_rng(0)
    M = (np.eye(3) + 0.05 * rng.normal(size=(64, 3, 3))).astype(np.float32)
    M[0] = -M[0]  # improper
    M[1] = 0.0    # degenerate
    want = np.asarray(jax.vmap(jchordal._project_so3)(M))
    got = chordal._project_so3(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], np.eye(3))


def test_optimize_with_chordal_init_reaches_jax_chi2(jax_ring):
    """OptimizerConfig.chordal_init is applied by GraphSLAM.optimize, as
    in the JAX package (it was ignored before)."""
    jgs = copy.deepcopy(jax_ring)
    jgs.cfg = dataclasses.replace(jgs.cfg, chordal_init=True,
                                  g2o_solver_num_iterations=64,
                                  per_tick_marginals="none")
    gs = _port_ring()
    gs.cfg = dataclasses.replace(gs.cfg, chordal_init=True,
                                 g2o_solver_num_iterations=64)
    snap = gs.snapshot()
    start = float(solve.chi2_only(snap))
    chordal_start = float(solve.chi2_only(
        snap._replace(poses=chordal.chordal_init(snap))))
    chi2 = gs.optimize()
    assert gs.chi2_initial == pytest.approx(chordal_start, rel=1e-6)
    assert gs.chi2_initial < start / 50
    want = jgs.optimize()
    assert want < 10.0
    np.testing.assert_allclose(chi2, want, rtol=1e-3)


def test_build_ring_graph_matches_jax(jax_ring):
    want, got = jax_ring, _port_ring()
    assert got.cap == dict(nodes=256, edges=256, planes=0, priors=0,
                           plane_edges=0, plane_priors=0, plane_plane=0)
    assert got.cfg.solver_backend == "dense"
    assert got.num_nodes == want.num_nodes == 128
    assert got.num_edges == want.num_edges == 128
    np.testing.assert_array_equal(got.fixed, want.fixed)
    np.testing.assert_array_equal(got._se3.mask(), want._se3.mask())
    for k in ("from_idx", "to_idx", "kernel"):
        np.testing.assert_array_equal(got._se3.arrays[k],
                                      want._se3.arrays[k])
    for k in ("info", "delta"):
        np.testing.assert_array_equal(got._se3.arrays[k],
                                      want._se3.arrays[k])
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got._se3.arrays["meas"],
                               want._se3.arrays["meas"], rtol=0, atol=2e-5)
