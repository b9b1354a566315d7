"""The port's `SharedTick` (models/coordinator.py) against its robots'
own ticks, and the batched solve's own cases.

`SharedTick`: one robot is `MrgSlam.optimization_tick` bit for bit; two
and three robots match serial ticks. Inputs: the small world of
tests/test_torch_backend.py (1.2 laps of a 12 m circle, 256-lane clouds,
their GICP covariances), driven by given odometry poses with a seeded
drift, as the JAX package's tests/test_coordinator_scale.py feeds its
robots: robot a drives more than a lap (and closes loops), b and c parts
of one; a tick every 22 frames. Two and three robots against serial
ticks give the same keyframes, loops on both paths (a) and within one of
each other, trajectories within 0.1 m (the JAX package's
tests/test_coordinator_scale.py): a pair bucket that holds other robots'
rows rounds its batched products otherwise, and so does the batched LM
(tests/test_torch_coordinator.py), which moves LM's stop.

`optimize_many` on the rings of tests/test_torch_coordinator.py: one
graph, a mixed config or the chain backend solve one by one, bit for bit
`optimize`; stores of other capacities are levelled up and their padding
changes no result (chi2 within 1e-5 relative, poses within 5e-3 m, the
batched product's rounding as there); a graph that stops early keeps,
bit for bit, the result it had when it stopped while the others iterate.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from mrg_slam_tpu_torch.config import OptimizerConfig
from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.graph import solve
from mrg_slam_tpu_torch.graph.builder import optimize_many
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.models.coordinator import SharedTick

from test_torch_backend import make_world
from test_torch_coordinator import SEEDS, _ring, _same_bits, _state
from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)
from test_torch_shared import _odometry, _tcloud
from test_torch_slice import JSLAM_NO_MARGINALS


CFG = config_from_fields(dataclasses.asdict(dataclasses.replace(
    JSLAM_NO_MARGINALS, multi_robot_names=("a", "b", "c"))))
# robot -> (frames of the world it drives, odometry seed): a closes loops
# over more than a lap, b and c drive parts of one
FEEDS = {"a": (range(0, 61), 11), "b": (range(30, 66), 12),
         "c": (range(0, 24), 13)}
TICK = 22


@pytest.fixture(scope="module")
def world():
    return make_world()


def _drive(world, names, tick):
    """Robots `names` over their FEEDS, a tick through `tick(slams, now)`
    every TICK frames and a last one -> {name: MrgSlam}."""
    slams = {n: MrgSlam(dataclasses.replace(CFG, own_name=n), device="cpu")
             for n in names}
    odo = {n: _odometry(world["traj"], FEEDS[n][0], FEEDS[n][1])
           for n in names}
    steps = max(len(FEEDS[n][0]) for n in names)
    for i in range(steps):
        for n in names:
            frames = FEEDS[n][0]
            if i < len(frames):
                f = frames[i]
                slams[n].process_scan(
                    i * 0.1, odo[n][i], _tcloud(*world["clouds"][f]),
                    source_covs=torch.from_numpy(world["covs"][f]))
        if (i + 1) % TICK == 0:
            tick(list(slams.values()), i * 0.1)
    tick(list(slams.values()), steps * 0.1)
    return slams


def _serial(slams, now):
    for s in slams:
        s.optimization_tick(now=now)


def _shared():
    box = {}

    def tick(slams, now):
        out = box.setdefault("st", SharedTick(slams)).tick_all(now=now)
        assert set(out) == {s.own_name for s in slams}

    return tick


def _loops(slam):
    return sum(e.type == "loop" for e in slam.db.edges)


def test_shared_tick_one_robot_is_optimization_tick(world):
    """SharedTick over one robot is the robot's own tick, bit for bit."""
    feeds = dict(FEEDS)
    FEEDS["a"] = (range(0, 24), 11)
    try:
        a = _drive(world, ["a"], _serial)["a"]
        b = _drive(world, ["a"], _shared())["a"]
    finally:
        FEEDS.update(feeds)
    assert len(a.tick_stats) == len(b.tick_stats) == 2
    for x, y in zip(a.tick_stats, b.tick_stats):
        assert (x.chi2_before, x.chi2_after, x.iterations, x.num_loops,
                x.pair_buckets) == (y.chi2_before, y.chi2_after,
                                    y.iterations, y.num_loops,
                                    y.pair_buckets)
    ta, tb = a.trajectory(), b.trajectory()
    assert ta.shape == tb.shape and (ta.view(np.uint32)
                                     == tb.view(np.uint32)).all()


@pytest.fixture(scope="module")
def fleets(world):
    """Three robots ticked one by one, and SharedTick over two and over
    three of them (a robot's serial ticks do not depend on the others)."""
    serial = _drive(world, ["a", "b", "c"], _serial)
    return serial, {2: _drive(world, ["a", "c"], _shared()),
                    3: _drive(world, ["a", "b", "c"], _shared())}


@pytest.mark.parametrize("R", [2, 3])
def test_shared_tick_matches_serial_ticks(fleets, R):
    serial, shared = fleets[0], fleets[1][R]
    for name, s2 in shared.items():
        s1 = serial[name]
        assert len(s2.db.own_keyframes()) == len(s1.db.own_keyframes())
        l1, l2 = _loops(s1), _loops(s2)
        assert abs(l1 - l2) <= 1, (name, l1, l2)
        if name == "a":
            assert l2 >= 1 and l1 >= 1
        t1, t2 = s1.trajectory(), s2.trajectory()
        assert t1.shape == t2.shape
        assert np.abs(t1[:, :3] - t2[:, :3]).max() < 0.1
        st = s2.tick_stats[-1]
        assert st.chi2_after <= st.chi2_before + 1e-6
        assert st.pair_buckets and st.iterations > 0
    # every robot ticked with a until its frames ran out, their pair rows
    # in shared buckets: each of those ticks lists the same buckets
    a = shared["a"].tick_stats
    for name, s2 in shared.items():
        mine = s2.tick_stats
        assert len(mine) >= 2
        assert [t.pair_buckets for t in a[:len(mine)]] == \
            [t.pair_buckets for t in mine]


def test_shared_tick_refuses_mixed_registration():
    a = MrgSlam(dataclasses.replace(CFG, own_name="a"), device="cpu")
    b = MrgSlam(dataclasses.replace(
        CFG, own_name="b", capacity_keyframe_points=128), device="cpu")
    with pytest.raises(ValueError, match="keyframe cloud capacity"):
        SharedTick([a, b])


# ---------------------------------------------------------------------------
# the batched solve's own cases (tests/test_torch_coordinator.py holds it
# to the JAX package's)
# ---------------------------------------------------------------------------

def test_optimize_many_levels_capacities_up_and_padding_is_inert():
    """A graph that grew (or was built larger) does not split the batch:
    the smaller store is reserved up to the larger, its live rows kept,
    and its padding changes no result: reserved to twice its capacity,
    a graph solves alone as it does at its own."""
    g1, g2 = _ring(0, n=16, cap=32), _ring(1, n=16, cap=64)
    optimize_many([g1, g2])
    assert g1.cap == g2.cap and g1.cap["nodes"] == 64
    assert g1.num_nodes == 16 and g1.last_marginals.shape == (16, 6, 6)
    own, padded = _ring(0, n=16, cap=32), _ring(0, n=16, cap=32)
    padded.reserve(nodes=64, edges=256)
    assert padded.cap["nodes"] == 64 and padded.cap["edges"] == 256
    own.optimize()
    padded.optimize()
    for g in (g1, padded):
        assert abs(g.chi2_final - own.chi2_final) <= 1e-5 * own.chi2_final
        np.testing.assert_allclose(g.poses, own.poses, rtol=0, atol=5e-3)


@pytest.mark.parametrize("case", ["one graph", "mixed configs", "chain"])
def test_optimize_many_solves_one_by_one(case, monkeypatch):
    """One graph, graphs whose OptimizerConfigs differ and the chain
    backend go through each graph's own `optimize`, bit for bit."""
    seeds = (0,) if case == "one graph" else (0, 1)
    gs = [_ring(s, backend="chain" if case == "chain" else "dense")
          for s in seeds]
    if case == "mixed configs":
        gs[1].cfg = dataclasses.replace(gs[1].cfg,
                                        g2o_solver_num_iterations=32)
    want = copy.deepcopy(gs)
    for g in want:
        g.optimize()
    calls = []
    monkeypatch.setattr(solve, "optimize_many",
                        lambda *a: calls.append(a))
    optimize_many(gs)
    assert not calls
    for g, w in zip(gs, want):
        _same_bits(_state(g), _state(w))


def test_optimize_many_keeps_an_early_stop():
    """In a batch of a graph that stops at once and graphs that iterate,
    the early one keeps, bit for bit, the result it had when it stopped,
    and counts only its own iterations; lam and nu freeze with it."""
    snaps = [_ring(s).snapshot() for s in SEEDS]
    cfg = OptimizerConfig(solver_backend="dense")
    full = solve.optimize_many(snaps, cfg)
    e, h = int(full.iterations.argmin()), int(full.iterations.argmax())
    k = int(full.iterations[e])
    assert k < int(full.iterations[h])
    cut = solve.optimize_many(snaps, dataclasses.replace(
        cfg, g2o_solver_num_iterations=k))
    assert int(cut.iterations[e]) == k
    for a, b in ((full.poses[e], cut.poses[e]),
                 (full.chi2_final[e], cut.chi2_final[e]),
                 (full.lambda_final[e], cut.lambda_final[e])):
        assert torch.equal(a, b)
    assert not torch.equal(full.poses[h], cut.poses[h])
    # the early graph is where a solve of it alone lands, within the
    # batched product's rounding
    alone = solve.optimize(snaps[e], cfg)
    assert abs(float(full.chi2_final[e]) - float(alone.chi2_final)) <= \
        1e-5 * float(alone.chi2_final)


@pytest.mark.parametrize("case", ["cg marginals", "chordal init"])
def test_optimize_many_options(case):
    """The batch's other per-tick paths: with "cg" marginals each graph's
    blocks are the selected inverse of its own live nodes at its batched
    poses, bit for bit what `marginals_selected` gives there; with
    chordal init each graph starts from its chordal estimate and lands
    where its own `optimize` lands (chi2 within 1e-5 relative, poses
    within 5e-3 m)."""
    gs = [_ring(s, n=16) for s in (0, 1)]
    change = (dict(per_tick_marginals="cg") if case == "cg marginals"
              else dict(chordal_init=True))
    for g in gs:
        g.cfg = dataclasses.replace(g.cfg, **change)
    want = copy.deepcopy(gs)
    optimize_many(gs)
    for g, w in zip(gs, want):
        if case == "cg marginals":
            live = g._live(g.snapshot())
            got = solve.marginals_selected(live, torch.arange(g.num_nodes))
            assert np.array_equal(g.last_marginals, got.numpy())
        else:
            w.optimize()
            assert abs(g.chi2_final - w.chi2_final) <= 1e-5 * w.chi2_final
            np.testing.assert_allclose(g.poses, w.poses, rtol=0, atol=5e-3)
