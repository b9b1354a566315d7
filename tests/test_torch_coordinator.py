"""The port's batched solve against its per-graph solve and the JAX
package's: `optimize_many` (graph/builder.py and graph/solve.py) and
`marginals_many`; and the multi-robot split with the rows'
configuration. tests/test_torch_shared_tick.py drives `SharedTick` and
holds the batched solve's other cases (one by one, capacities, an early
stop), tests/test_torch_replay_multirobot.py `replay_multirobot`.

Inputs: bench-style ring graphs (`build_ring_graph`: 24 nodes in a store
of 32, one loop edge); the JAX package's graphs are filled from the
port's numpy staging buffers, so both solve the same numbers.

Tolerances and why:
- `optimize_many` against each graph's own `optimize` and the JAX
  package's `optimize_many`: chi2 within 1e-5 relative, poses within
  5e-3 m and marginals within 2e-3 + 5 % (the bars of the JAX package's
  tests/test_coordinator.py). The batched step multiplies R matrices in
  one batched product, which rounds otherwise than one product, and on
  these rings LM's stop (an accepted step improving chi2 by under 1e-6)
  falls on rounding noise: the iteration counts differ, chi2 by ~5e-6.
  The JAX package solves with its per-tick marginals off: compiling them
  too takes this file past its time (its vmapped LM alone compiles for
  ~20 s on the CPU, and its persistent cache does not keep it); the
  port's batched marginals are held to its per-graph ones, which
  tests/test_torch_graph.py holds to the JAX package's.
- `marginals_many`: the exact blocks within 1e-4 relative of `marginals`
  (a batched Cholesky), the block-Jacobi ones bit for bit.
- The split: equal to the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mrg_slam_tpu import config as jconfig
from mrg_slam_tpu.graph.builder import GraphSLAM as JGraphSLAM
from mrg_slam_tpu.graph.builder import optimize_many as joptimize_many
from mrg_slam_tpu.pipeline import multirobot_split as jsplit

from mrg_slam_tpu_torch.graph import solve
from mrg_slam_tpu_torch.graph.builder import optimize_many
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.pipeline import baseline_runs as bl
from mrg_slam_tpu_torch.pipeline import multirobot_split as split
from mrg_slam_tpu_torch.pipeline.baseline_runs import build_ring_graph

from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)

SEEDS = (0, 1, 2)


def _ring(seed, n=24, cap=32, backend="dense", noise=0.03):
    return build_ring_graph(n_nodes=n, capacity_nodes=cap,
                            capacity_edges=2 * cap, backend=backend,
                            seed=seed, noise_scale=noise, device="cpu")


def _jax_copy(g):
    """The JAX package's GraphSLAM with the port graph's nodes and edges
    (numpy staging buffers: same inputs, no JAX op to build them)."""
    jg = JGraphSLAM(jconfig.OptimizerConfig(solver_backend="dense",
                                            per_tick_marginals="none"),
                    capacity_nodes=g.cap["nodes"],
                    capacity_edges=g.cap["edges"])
    for i in range(g.num_nodes):
        jg.add_se3_node(g._poses[i], fixed=bool(g._node_fixed[i]))
    a = g._se3.arrays
    for e in range(g.num_edges):
        jg.add_se3_edge(int(a["from_idx"][e]), int(a["to_idx"][e]),
                        a["meas"][e], a["info"][e])
    return jg


def _state(g):
    return (g.chi2_initial, g.chi2_final, g.last_iterations,
            g.poses.copy(), None if g.last_marginals is None
            else g.last_marginals.copy())


def _same_bits(a, b):
    assert a[:3] == b[:3]
    for x, y in zip(a[3:], b[3:]):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.shape == y.shape
            assert (x.view(np.uint32) == y.view(np.uint32)).all()


# ---------------------------------------------------------------------------
# optimize_many
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rings():
    """Three rings solved alone, batched, and batched by the JAX package
    -> (alone, batched, jax)."""
    alone = [_ring(s) for s in SEEDS]
    for g in alone:
        g.optimize()
    batched = [_ring(s) for s in SEEDS]
    optimize_many(batched)
    jgs = [_jax_copy(g) for g in (_ring(s) for s in SEEDS)]
    joptimize_many(jgs)  # its per-tick marginals off: see the docstring
    return alone, batched, jgs


@pytest.mark.parametrize("k", range(len(SEEDS)))
def test_optimize_many_matches_optimize_and_jax(rings, k):
    alone, batched, jgs = rings
    g, ref, jg = batched[k], alone[k], jgs[k]
    assert g.chi2_final < 0.1 * g.chi2_initial
    assert 0 < g.last_iterations <= g.cfg.g2o_solver_num_iterations
    for other in (ref, jg):
        assert abs(g.chi2_final - other.chi2_final) <= 1e-5 * other.chi2_final
        np.testing.assert_allclose(g.poses, other.poses, rtol=0, atol=5e-3)
    assert jg.last_marginals is None
    np.testing.assert_allclose(g.last_marginals, ref.last_marginals,
                               rtol=0.05, atol=2e-3)
    np.testing.assert_allclose(g.chi2_initial, ref.chi2_initial, rtol=1e-6)


def test_marginals_many_matches_marginals():
    gs = [_ring(s).snapshot() for s in SEEDS]
    many = solve.marginals_many(gs)
    block = solve.marginals_many(gs, exact=False)
    for r, g in enumerate(gs):
        np.testing.assert_allclose(many[r].numpy(),
                                   solve.marginals(g).numpy(),
                                   rtol=1e-4, atol=1e-7)
        assert torch.equal(block[r], solve.marginals(g, exact=False))


# ---------------------------------------------------------------------------
# the split, and the rows' configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,R,ov,rev", [(100, 2, 0.3, ()), (120, 2, 0.35,
                                                               (1,)),
                                        (97, 3, 0.25, (0, 2)),
                                        (10, 1, 0.25, ())])
def test_split_matches_jax(n, R, ov, rev):
    assert split.split_windows(n, R, ov) == jsplit.split_windows(n, R, ov)
    frames = [(0.1 * i, np.full((2, 3), i, np.float32)) for i in range(n)]
    got = split.split_frames(frames, R, ov, rev)
    want = jsplit.split_frames(frames, R, ov, rev)
    assert len(got) == len(want) == R
    for g, w in zip(got, want):
        assert [s for s, _ in g] == [s for s, _ in w]
        assert all(a is b for (_, a), (_, b) in zip(g, w))
    for r in rev:  # reversed windows: scans backwards, stamps rising
        assert [s for s, _ in got[r]] == sorted(s for s, _ in got[r])
        assert got[r][0][1][0, 0] > got[r][-1][1][0, 0]


def test_base_cfg_names_the_jax_package_default_robots():
    """The rows' configuration keeps the JAX package's robot names
    ("atlas", "bestla"), which `MrgSlam` now accepts."""
    from mrg_slam_tpu.pipeline import baseline_runs as jbl

    cfg = bl._base_cfg()
    assert cfg.slam.multi_robot_names == \
        jbl._base_cfg().slam.multi_robot_names == ("atlas", "bestla")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jbl._base_cfg())
    MrgSlam(cfg.slam, device="cpu")
