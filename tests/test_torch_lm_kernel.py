"""The dense LM iteration's kernels (graph/lm_dense.py, csrc/lm_dense.cu).

On the CPU (no card needed): which solves take the kernels, and the
fixed summation order of the index they sum H in, contribution by
contribution, with H summed in that order equal to `assemble_dense`'s.

On the card (marker `cuda`; without one they skip): the three kernels
against their plain twin, the op path of graph/solve.py, on seeded SE3
graphs with padded node and edge rows, the fixed anchor and every robust
kernel id, one graph and four side by side; the same graph solved twice
bit for bit; whole solves against the CPU. On a machine with a card and
without JAX (tests/conftest.py imports it):
`python -m pytest tests/test_torch_lm_kernel.py -q --noconftest
-o addopts=""`.

Tolerances on the card, kernel against the op path on the same card
(float32; both sum in fixed orders, but different ones, and the kernel's
products contract into FMAs):
- Hs: 2e-4 absolute. By Cauchy-Schwarz every equilibrated entry, and
  every edge term of it, lies in [-1, 1], and a term's own rounding is
  a few 1e-6 of that. The two sides round a residual of poses ~20 m
  from the origin differently, by ~1e-6 m, and a robust weight is a
  function of the residual that amplifies it: Tukey's (1 - e/d2)^2 near
  its cutoff and Welsch's exp(-e/d2) far out move by ~1e-4 relative.
- bs, the gradient: 2e-5 of the largest entry; chi2: 1e-5 relative (a
  sum of non-negative terms, each residual rounded differently).
- the trial: poses 1e-4 (one retraction of poses ~20 m out, a few dozen
  float32 ulps), pred and the trial's chi2 1e-4 relative (pred cancels
  between its two terms; the trial's residuals are smaller than the
  start's, so their rounding weighs more), lam 1e-3 relative (the gain
  ratio divides two such differences), nu and done exactly.
"""

import numpy as np
import pytest
import torch

from mrg_slam_tpu_torch.graph import lm_dense, solve
from mrg_slam_tpu_torch.graph.types import KERNEL_IDS

KERNELS = list(KERNEL_IDS)


def test_path_choice_and_index_order():
    """Which solves take the kernels: the dense backend, no group, the
    card, SE3 edges only. The index of a small graph, block by block:
    each node's diagonal takes slot 0 of the edges leaving it and slot 1
    of those entering it, in edge order (all four of a self-loop); a
    pair (a, b), a < b, slot 2 of a -> b and slot 3 of b -> a; a padding
    row is in no block. H summed in that order is assemble_dense's H."""
    from mrg_slam_tpu_torch.graph.builder import GraphSLAM
    from mrg_slam_tpu_torch.utils import se3, se3np

    def exp(scale):
        return se3.pose_exp(torch.from_numpy(rng.normal(
            scale=scale, size=6).astype(np.float32))).numpy()

    take = lm_dense.path_takes_kernels
    assert take("cuda", "dense", None, 0, [0, 0, 0, 0])
    assert not take("cpu", "dense", None, 0, [0, 0, 0, 0])
    for backend in ("cg", "chain"):
        assert not take("cuda", backend, None, 0, [0, 0, 0, 0])
    assert not take("cuda", "dense", object(), 0, [0, 0, 0, 0])
    assert not take("cuda", "dense", None, 2, [0, 0, 0, 0])
    for k in range(4):  # priors, plane edges, plane priors, plane-plane
        caps = [0, 0, 0, 0]
        caps[k] = 8
        assert not take("cuda", "dense", None, 0, caps)

    g = GraphSLAM(capacity_nodes=4, capacity_edges=8, device="cpu")
    rng = np.random.default_rng(5)
    poses = [exp(0.3) for _ in range(3)]
    for i, p in enumerate(poses):
        g.add_se3_node(p, fixed=(i == 0))
    info = np.diag([50.0] * 3 + [200.0] * 3)
    noisy = exp(0.05)
    # edges 0..4: 0->1, 2->1, 1->2, 2->2 (a self-loop), 0->2 (Huber)
    for a, b in ((0, 1), (2, 1), (1, 2), (2, 2)):
        g.add_se3_edge(a, b, se3np.pose_compose(
            se3np.pose_between(poses[a], poses[b]), noisy), info)
    g.add_se3_edge(0, 2, se3np.pose_between(poses[0], poses[2]), info,
                   kernel="Huber", kernel_delta=0.1)
    a = g._se3.arrays
    blocks, codes = lm_dense.build_index(a["from_idx"], a["to_idx"],
                                         g._se3.mask(), 4)
    lists = [[(int(c) >> 2, int(c) & 3) for c in codes[s:e]]
             for _, _, s, e in blocks]
    assert [tuple(x[:2]) for x in blocks] == [
        (0, 0), (1, 1), (2, 2), (3, 3), (0, 1), (0, 2), (1, 2)]
    assert lists == [
        [(0, 0), (4, 0)],                                  # node 0
        [(0, 1), (1, 1), (2, 0)],                          # node 1
        [(1, 0), (2, 1), (3, 0), (3, 1), (3, 2), (3, 3), (4, 1)],  # node 2
        [],                                                # node 3: none
        [(0, 2)],                                          # (0, 1)
        [(4, 2)],                                          # (0, 2)
        [(1, 3), (2, 2)]]                                  # (1, 2)

    # a store on the CPU brings no index, and its solve keeps the op path
    snap, idx = g._snapshot()
    assert idx is None and not lm_dense.takes_kernels(snap, "dense")

    # H in the index's order, from the op path's per-edge terms
    lin = solve.linearize(snap)
    H_ref = solve.assemble_dense(snap, lin)[0].numpy()
    Ji, Jj, W = (x.double().numpy() for x in (lin.Ji, lin.Jj, lin.W_se3))
    prods = [Ji.transpose(0, 2, 1) @ W @ Ji, Jj.transpose(0, 2, 1) @ W @ Jj,
             Ji.transpose(0, 2, 1) @ W @ Jj]
    H = np.zeros((24, 24))
    for (na, nb, s, e) in blocks:
        blk = np.zeros((6, 6))
        for c in codes[s:e]:
            edge, slot = int(c) >> 2, int(c) & 3
            blk += prods[2][edge].T if slot == 3 else prods[slot][edge]
        H[6 * na:6 * na + 6, 6 * nb:6 * nb + 6] = blk
        H[6 * nb:6 * nb + 6, 6 * na:6 * na + 6] = blk.T
    free = np.repeat([0.0, 1.0, 1.0, 0.0], 6)  # node 0 fixed, 3 unused
    H = H * free[:, None] * free[None, :] + np.diag(1.0 - free)
    np.testing.assert_allclose(H, H_ref, rtol=1e-5,
                               atol=1e-5 * np.abs(H_ref).max())


# -- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _graph(device, cap_n, cap_e, seed, live=None):
    """A noisy ring of `live` nodes (default 3/4 of cap_n) from a fixed
    first node, with chords that cycle through every robust kernel id,
    each measured 0.05 off the estimates (a residual that is not
    rounding noise)."""
    from mrg_slam_tpu_torch.pipeline.baseline_runs import build_ring_graph
    from mrg_slam_tpu_torch.utils import se3, se3np

    n = live or 3 * cap_n // 4
    g = build_ring_graph(n_nodes=n, capacity_nodes=cap_n,
                         capacity_edges=cap_e, backend="dense", seed=seed,
                         noise_scale=0.05, device=device)
    rng = np.random.default_rng(seed)
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    for k in range(min(cap_e // 4, 2 * n)):
        i, j = rng.choice(n, size=2, replace=False)
        off = se3.pose_exp(torch.from_numpy(rng.normal(
            scale=0.05, size=6).astype(np.float32))).numpy()
        g.add_se3_edge(i, j, se3np.pose_compose(
            se3np.pose_between(g.poses[i], g.poses[j]), off),
            info * 0.3, kernel=KERNELS[k % len(KERNELS)],
            kernel_delta=float(rng.uniform(0.3, 3.0)))
    return g


def one_iteration(dev, cap_n, cap_e, R, lam0=1e-3):
    """R seeded graphs (`_graph`) side by side through one iteration's
    kernels and the library's solve -> (batch, snapshots, y, dy), each
    kernel launched once."""
    snaps, idxs = zip(*(_graph(dev, cap_n, cap_e, 10 + r)._snapshot()
                        for r in range(R)))
    b = lm_dense._batch(list(snaps), lm_dense._stack_index(list(idxs)),
                        lam0)
    launches = (lm_dense.linearize_cuda.launches,
                lm_dense.assemble_cuda.launches,
                lm_dense.trial_cuda.launches)
    lm_dense.linearize_cuda(b)
    lm_dense.assemble_cuda(b, init=True)
    y, dy, info = lm_dense._solve_step(b)
    lm_dense.trial_cuda(b, y, dy, info, True, 1e-6)
    torch.cuda.synchronize()
    assert (lm_dense.linearize_cuda.launches,
            lm_dense.assemble_cuda.launches,
            lm_dense.trial_cuda.launches) == tuple(x + 1 for x in launches)
    assert (info == 0).all()
    return b, snaps, y, dy


def check_against_plain(b, snaps, y, dy, lam0=1e-3) -> dict:
    """`one_iteration`'s outputs against the op path on the same card,
    graph by graph, within the module's tolerances -> the largest
    absolute gap of Hs, bs, the gradient and the trial poses."""
    dev = b.poses.device
    lam = torch.full((), lam0, device=dev)
    L = b.Hs.shape[1]  # the live nodes' dofs
    gaps = dict(Hs=0.0, bs=0.0, grad=0.0, trial=0.0)
    for r, g in enumerate(snaps):
        pl = lm_dense.assemble_plain(g, lam)
        # the padding the solve leaves out: identity rows, zero rhs
        D = pl["Hs"].shape[0]
        assert torch.equal(pl["Hs"][L:, L:], torch.eye(D - L, device=dev))
        assert not pl["Hs"][:L, L:].any() and not pl["bs"][L:].any()
        torch.testing.assert_close(b.Hs[r], pl["Hs"][:L, :L], rtol=0,
                                   atol=2e-4)
        for got, want in ((b.bs[r, :, 0], pl["bs"][:L]),
                          (b.vecs[3, r], pl["grad"])):
            torch.testing.assert_close(
                got, want, rtol=0, atol=2e-5 * float(want.abs().max()))
        torch.testing.assert_close(b.state[1, r], pl["chi2"], rtol=1e-5,
                                   atol=0)
        tp = lm_dense.trial_plain(
            g, torch.nn.functional.pad((y + dy)[r, :, 0], (0, D - L)),
            pl["s"], pl["diag"], pl["b"], pl["chi2"], lam,
            torch.full_like(lam, 2.0), True, 1e-6)
        torch.testing.assert_close(b.trial[r], tp["trial"], rtol=0,
                                   atol=1e-4)
        torch.testing.assert_close(b.state[4, r], tp["pred"], rtol=1e-4,
                                   atol=0)
        torch.testing.assert_close(b.state[5, r], tp["chi2_new"],
                                   rtol=1e-4, atol=0)
        torch.testing.assert_close(b.state[2, r], tp["lam"], rtol=1e-3,
                                   atol=0)
        assert float(b.state[3, r]) == float(tp["nu"])
        assert bool(b.flags[0, r]) == bool(tp["done"])
        torch.testing.assert_close(b.poses[r], tp["poses"], rtol=0,
                                   atol=1e-4)
        for k, got, want in (("Hs", b.Hs[r], pl["Hs"][:L, :L]),
                             ("bs", b.bs[r, :, 0], pl["bs"][:L]),
                             ("grad", b.vecs[3, r], pl["grad"]),
                             ("trial", b.trial[r], tp["trial"])):
            gaps[k] = max(gaps[k], float((got - want).abs().max()))
    return gaps


@pytest.mark.cuda
@pytest.mark.parametrize("cap_n,cap_e,R", [(128, 512, 1), (256, 1024, 1),
                                           (128, 512, 4)])
def test_lm_kernels_match_plain(dev, cap_n, cap_e, R):
    """One iteration's kernels against the op path on the same card,
    graph by graph: after linearize and assemble, Hs and bs over the live
    nodes (the op path's rows of the padding are identity rows with a
    zero right-hand side), the gradient and chi2; after the library's
    solve and the trial, the trial poses, pred, the trial's chi2, lam,
    nu, done and the poses taken."""
    b, snaps, y, dy = one_iteration(dev, cap_n, cap_e, R)
    assert b.Hs.shape[1] == 6 * (3 * cap_n // 4)
    check_against_plain(b, snaps, y, dy)


@pytest.mark.cuda
def test_lm_kernels_repeat_bit_for_bit(dev):
    """The same graph solved twice on the card: the same poses, chi2 and
    iterations, bit for bit (no atomics, fixed sums)."""
    from mrg_slam_tpu_torch.config import OptimizerConfig

    cfg = OptimizerConfig(solver_backend="dense",
                          g2o_solver_num_iterations=64)
    g = _graph(dev, 256, 1024, 7)
    runs = [solve.optimize(g.snapshot(), cfg) for _ in range(2)]
    assert all(r.fused for r in runs)
    assert runs[0].iterations == runs[1].iterations
    for f in ("poses", "chi2_final", "lambda_final"):
        a, b = (getattr(r, f) for r in runs)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_lm_kernels_with_no_iteration_return_the_start(dev):
    """An iteration cap of 0 runs no step: the kernel path returns the
    start's poses and its chi2 as both chi2_initial and chi2_final, as
    the op path does (its chi2 within the linearize tolerance above)."""
    from mrg_slam_tpu_torch.config import OptimizerConfig

    cfg = OptimizerConfig(solver_backend="dense",
                          g2o_solver_num_iterations=0)
    snap = _graph(dev, 128, 512, 3).snapshot()
    res = solve.optimize(snap, cfg)
    chi2 = solve.linearize(snap).chi2
    assert res.fused and res.iterations == 0
    assert torch.equal(res.poses, snap.poses)
    assert torch.equal(res.chi2_initial, res.chi2_final)
    torch.testing.assert_close(res.chi2_final, chi2, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 4])
def test_lm_optimize_on_the_card_matches_the_cpu(dev, R):
    """Whole solves through GraphSLAM.optimize (R = 1) and the builder's
    optimize_many (R = 4) on the card against the same on the CPU (the op
    path): 96-node rings in stores of 128 with Huber loop edges measured
    from the ground truth, as loops are: every LM iteration on the card
    ran the kernels, one read each, chi2 within rel 1e-3 and poses within
    1e-3 m (test_tick_on_the_card_matches_the_cpu's bars)."""
    from mrg_slam_tpu_torch.graph.builder import optimize_many
    from mrg_slam_tpu_torch.pipeline.baseline_runs import build_ring_graph
    from mrg_slam_tpu_torch.utils import profiling, se3, se3np

    n = 96
    th = 2 * np.pi * np.arange(n) / n
    truth = se3.pose_exp(torch.from_numpy(np.stack(
        [20 * np.cos(th), 20 * np.sin(th), np.zeros(n), np.zeros(n),
         np.zeros(n), th], axis=1).astype(np.float32))).numpy()
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)

    def rings(device):
        out = []
        for s in range(R):
            g = build_ring_graph(n_nodes=n, capacity_nodes=128,
                                 capacity_edges=512, backend="dense",
                                 seed=20 + s, device=device)
            for i in range(0, 60, 6):
                j = i + 30 + s
                g.add_se3_edge(i, j, se3np.pose_between(truth[i], truth[j]),
                               info * 0.25, kernel="Huber",
                               kernel_delta=1.0)
            out.append(g)
        return out

    gpu, cpu = rings(dev), rings("cpu")
    profiling.reset()
    profiling.enable(True)
    try:
        if R == 1:
            gpu[0].optimize()
        else:
            optimize_many(gpu)
        reads = sum(r.name == "read.lm_iteration"
                    for r in profiling.records())
    finally:
        profiling.enable(False)
        profiling.reset()
    if R == 1:
        cpu[0].optimize()
    else:
        optimize_many(cpu)
    assert reads == max(g.last_iterations for g in gpu)
    for g, c in zip(gpu, cpu):
        assert g.last_fused_iterations == g.last_iterations > 0
        assert c.last_fused_iterations == 0
        assert abs(g.chi2_final - c.chi2_final) <= 1e-3 * c.chi2_final
        assert np.abs(g.poses[:, :3] - c.poses[:, :3]).max() < 1e-3
