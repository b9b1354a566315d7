"""The port's distributed pose-graph solve (parallel/dist_solver.py) over
gloo ranks on the CPU, against the port's single-device solve and the
JAX package's distributed solve.

The graphs are those of the JAX package's tests/test_distributed.py:14-110
(a 24-node noisy ring in a 64-node store, and the same ring with every
edge family), read with the JAX package's results from
tests/data/dist_solver_reference.json (`python
tools/dist_solver_reference.py`: its single-device `optimize` and its
`optimize_distributed` on meshes of 2 and 4 of 8 virtual CPU devices), so
JAX's distributed solver, which compiles for minutes, does not run here.
Each world size (2 and 4 ranks, one torch thread a rank) is one spawn
running its cases (the plain ring at 2 ranks only), so process start-up is paid once a world, and both
worlds start together. Each world also sums seeded tensors over the
group, the world of 4 over a subgroup of 3 ranks too (`solve._sum_over`:
recursive doubling at 2 and 4 ranks, `all_reduce` at 3): every rank
gets the same bits, within float32 rounding of the float64 sum.

Bounds and why: the JAX package's own (tests/test_distributed.py): chi2
within 5e-3 relative, poses within 2e-2 m (the ring) and 3e-2 m (every
family; planes too). A sharded sum adds in another order than one
device's, so a solve may take another LM step in the flat valley of equal
chi2; it lands within these bounds, not bit for bit. Every rank of a
world returns bitwise the same poses: the all-reduce hands every rank the
same sums, and every LM decision follows from them.

With no group (`group=None`) the solver is the single-device one bit for
bit: each backend's poses, planes and chi2 on the every-family graph hash
to what the solver gave before it took a group (one torch thread).
"""

import base64
import dataclasses
import hashlib
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from mrg_slam_tpu_torch.config import OptimizerConfig
from mrg_slam_tpu_torch.graph import solve
from mrg_slam_tpu_torch.graph.types import EDGE_TABLES, PoseGraphData
from mrg_slam_tpu_torch.parallel import dist_solver as ds

REF = json.loads((Path(__file__).parent / "data"
                  / "dist_solver_reference.json").read_text())
WORLDS = (2, 4)
CASES = tuple(REF["cases"])
# the cases a world runs: the plain ring's cg (1200 reductions, most of
# this file's time) at 2 ranks only; every family on all three backends
# at both
WORLD_CASES = {2: CASES, 4: tuple(c for c in CASES if c != "ring_cg")}
POSE_ATOL = {"ring": 2e-2, "families": 3e-2}
CHI2_REL = 5e-3
# sha256 of (poses, planes, chi2_final) of `solve.optimize` on the
# every-family graph, one torch thread, before the solver took a group
TODAY = {
    "dense": "f007ba34f69ac7752d3a83fe35a1b4c3165998a6a7bb1f4c1ac7e0ef06d4421b",
    "cg": "090f2b78b0738f4b5378c379c2dae93380bd614dcb5c78e2f83dcad05284a811",
    "chain": "3977cb9fab78a2a572cc498b91c5ef35a645ce63e24810c09e49218799b09ef8",
}


def _decode(d) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]), d["dtype"]).reshape(
        d["shape"]).copy()


def graph(name: str) -> PoseGraphData:
    """A graph of the reference file on the CPU: its edge tables are their
    live rows over the empty table's defaults."""
    d = REF["graphs"][name]
    tables = {}
    for f, cls in EDGE_TABLES.items():
        t = cls.empty(d[f]["capacity"], device="cpu")
        fields = {}
        for k in cls._fields:
            full = getattr(t, k).clone()
            rows = torch.from_numpy(_decode(d[f]["rows"][k]))
            full[: rows.shape[0]] = rows
            fields[k] = full
        tables[f] = cls(**fields)
    return PoseGraphData(**tables, **{
        f: torch.from_numpy(_decode(d[f])) for f in PoseGraphData._fields
        if f not in tables})


def config(case: str) -> OptimizerConfig:
    return OptimizerConfig(**REF["cases"][case]["config"])


def sums(group, device):
    """`_sum_over` of tensors seeded by each rank's number -> (this
    rank's sums, the float64 sums of every rank's tensors)."""
    shapes = [(3,), (5, 2), (1000,)]
    mine = [torch.from_numpy(np.random.default_rng(group.rank()).normal(
        size=sh).astype(np.float32)) for sh in shapes]
    want = [sum(np.random.default_rng(r).normal(size=sh).astype(np.float32)
                .astype(np.float64) for r in range(group.size()))
            for sh in shapes]
    got = solve._sum_over(group, *mine)
    return [g.numpy() for g in got], want


def rank_work(group, device, cases):
    """What a rank of a world runs: every case, then the sums over the
    world and, in the world of 4, over a subgroup of ranks 0-2 (None on
    rank 3)."""
    import torch.distributed as dist

    out = ds.solve_graphs(group, device, cases), {group.size(): sums(
        group, device)}
    if group.size() == 4:
        sub = dist.new_group([0, 1, 2])
        out[1][3] = sums(sub, device) if group.rank() < 3 else None
    return out


@pytest.fixture(scope="module")
def runs():
    """Every case over 2 and over 4 ranks, and the sums over 2, 3 and 4:
    ({world: [per rank: [per case: result dict]]}, {size: [per rank:
    sums]})."""
    with ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {w: ex.submit(ds.run_ranks, rank_work, w, "cpu", ([
            (graph(REF["cases"][c]["graph"]), config(c))
            for c in WORLD_CASES[w]],), timeout_s=240.0) for w in WORLDS}
        one = _one_device()  # while the ranks run
        out = {w: f.result() for w, f in futs.items()}
    solves = {w: [rank[0] for rank in r] for w, r in out.items()}
    summed = {w: [rank[1][w] for rank in r] for w, r in out.items()}
    summed[3] = [rank[1][3] for rank in out[4]][:3]
    return solves, summed, one


@pytest.mark.parametrize("world", (2, 3, 4))
def test_sums_over_a_group_give_every_rank_the_same_bits(runs, world):
    per_rank = runs[1][world]
    assert len(per_rank) == world
    first, want = per_rank[0]
    for got, _ in per_rank[1:]:
        for a, b in zip(got, first):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    for a, w in zip(first, want):
        np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-6)


def _one_device():
    """The port's single-device solve of each case (one torch thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {c: solve.optimize(graph(REF["cases"][c]["graph"]),
                                  config(c)) for c in CASES}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_bits(runs, world):
    ranks = runs[0][world]
    assert len(ranks) == world and ds.ranks_equal(ranks)
    for r in ranks[1:]:
        assert [c["chi2_final"] for c in r] == [
            c["chi2_final"] for c in ranks[0]]
    # every rank made the same all-reduces
    assert len({tuple(c["all_reduces"] for c in r) for r in ranks}) == 1


@pytest.mark.parametrize("case,world", [(c, w) for w in WORLDS
                                        for c in WORLD_CASES[w]])
def test_case_matches_one_device_and_the_jax_package(runs, case, world):
    ref = REF["cases"][case]
    name = ref["graph"]
    n, n_pl = REF["nodes"][name], REF["planes"][name]
    got = runs[0][world][0][WORLD_CASES[world].index(case)]
    one = runs[2][case]
    jax_dist = ref[f"world{world}"]
    assert got["chi2_final"] < got["chi2_initial"]
    assert got["all_reduces"] > 0
    for want in (float(one.chi2_final), jax_dist["chi2_final"],
                 ref["single"]["chi2_final"]):
        assert abs(got["chi2_final"] - want) / want < CHI2_REL, (
            got["chi2_final"], want)
    atol = POSE_ATOL[name]
    for want in (one.poses.numpy()[:n], _decode(jax_dist["poses"])):
        np.testing.assert_allclose(got["poses"][:n, :3], want[:, :3],
                                   rtol=0, atol=atol)
    if n_pl:
        for want in (one.planes.numpy()[:n_pl], _decode(jax_dist["planes"])):
            np.testing.assert_allclose(got["planes"][:n_pl], want, rtol=0,
                                       atol=3e-2)
        assert abs(got["planes"][1, 2]) > 0.97  # normal pulled to +z


def test_shards_pad_with_masked_lanes():
    g = graph("families")
    world = 4
    for rank in range(world):
        s = ds.shard_edges(g, rank, world)
        for f in EDGE_TABLES:
            cap = getattr(g, f).mask.shape[0]
            assert getattr(s, f).mask.shape[0] == -(-cap // world)
    # the padded lanes are masked, and the shards hold every live edge once
    for f in EDGE_TABLES:
        live = int(getattr(g, f).mask.sum())
        assert sum(int(getattr(ds.shard_edges(g, r, 3), f).mask.sum())
                   for r in range(3)) == live
    padded = ds.pad_edges_to(g, 5)
    assert not padded.se3.mask[64:].any() and padded.se3.mask.shape[0] == 65
    with pytest.raises(ValueError, match="cannot split"):
        solve._chain_K(96, 5)
    assert solve._chain_K(64, 2) == 32 and solve._chain_K(64, 4) == 16


@pytest.mark.parametrize("backend", ["dense", "cg", "chain"])
def test_no_group_is_the_one_device_solve_bit_for_bit(backend):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = solve.optimize(graph("families"), dataclasses.replace(
            OptimizerConfig(), solver_backend=backend,
            g2o_solver_num_iterations=48))
    finally:
        torch.set_num_threads(n)
    h = hashlib.sha256()
    for t in (res.poses, res.planes, res.chi2_final):
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == TODAY[backend]
