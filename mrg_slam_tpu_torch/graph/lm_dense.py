"""The dense LM iteration of an SE(3) pose graph on the card: the kernels
of csrc/lm_dense.cu around the library's Cholesky, and who takes them.

An iteration of `solve.optimize`'s dense backend on the op path
(linearize -> assemble_dense -> dense_delta -> _retract_all -> a second
linearize -> _lm_schedule -> _take) is ~1100 PyTorch ops, each a launch
of a few microseconds of card time behind far more of host dispatch.
Here it is three kernels and the library's factor and solves:

1. `linearize_cuda` (mrg_lm_linearize): each edge row's residual,
   Jacobians, robust weight, chi2 term and its 6x6 products and
   gradients, for the graphs whose last step was accepted;
2. `assemble_cuda` (mrg_lm_assemble): the nonzero 6x6 blocks of the
   damped, equilibrated, free-masked Hs, and bs, the scales, the
   diagonal, b and the gradient, each H entry summed in the order of an
   index built once a solve (`build_index`), without atomics;
3. `torch.linalg.cholesky_ex` and two `torch.cholesky_solve`s with one
   step of refinement, as `solve.dense_delta` takes them;
4. `trial_cuda` (mrg_lm_trial): x, the predicted reduction, the trial
   poses and their robust chi2, Nielsen's schedule, the take, and the
   `done` flag that the iteration's one host read copies out.

On an accepted step the next iteration's linearize computes the
Jacobians at the accepted poses, which are the numbers the op path's
trial linearization hands on; after a rejected step the poses did not
move and the terms stay. So nothing of the mathematics is left out and
nothing is computed twice.

Who takes them depends only on what a solve can see in its input
(`takes_kernels`): the dense backend, one device (no process group),
CUDA tensors, and an SE3 table as the graph's only edge family with
capacity, with no plane pool. Every other solve, and every solve on the
CPU, runs the op path of graph/solve.py, which is these kernels' plain
twin: `assemble_plain` and `trial_plain` compute the kernels' outputs
with it, for the tests. On a CUDA tensor a wrapper launches its kernel
or raises; it never falls back.

`optimize` runs R graphs of one shape side by side (the batched LM of
`solve.optimize_many`; R = 1 for `solve.optimize`): a graph that is done
is frozen, and the batch reads one flag a graph an iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import OptimizerConfig
from ..ops import native
from ..utils import profiling
from .types import PoseGraphData

ROWS = 120  # floats an edge row contributes (csrc/lm_dense.cu: kRows)
# the edge families besides SE3 (PoseGraphData's fields, GraphSLAM.cap's
# keys); a table of any of them with capacity keeps a graph on the op path
AUX_TABLES = ("priors", "plane_edges", "plane_priors", "plane_plane")


class LMIndex(NamedTuple):
    """The fixed summation order of a graph's nonzero H blocks.

    blocks (K, 4) int32: node a, node b, first and end code of the
    block's contributions; rows 0..N-1 are the nodes' diagonal blocks,
    then one row per linked node pair a < b. codes (C,) int32: edge * 4 +
    slot, slot 0 Jf^T W Jf, 1 Jt^T W Jt, 2 Jf^T W Jt, 3 its transpose.
    A leading graph axis when stacked; padding rows have a = -1. live:
    the live nodes, a prefix of the store (of a stack, the most): the
    solve factors their 6 live dofs and leaves the padding's identity
    rows out."""

    blocks: torch.Tensor
    codes: torch.Tensor
    live: int


class Result(NamedTuple):
    poses: torch.Tensor         # (R, N, 7)
    chi2_initial: torch.Tensor  # (R,)
    chi2_final: torch.Tensor    # (R,)
    iterations: torch.Tensor    # (R,) int64, each graph's own
    lambda_final: torch.Tensor  # (R,)
    passes: int                 # iterations the batch ran


def path_takes_kernels(device, backend: str, group, n_planes: int,
                       aux_capacities: Sequence[int]) -> bool:
    """Whether a solve takes the kernels: the dense backend, no process
    group, a CUDA device, no plane pool and no capacity in any table of
    AUX_TABLES."""
    return (torch.device(device).type == "cuda" and backend == "dense"
            and group is None and n_planes == 0
            and not any(aux_capacities))


def takes_kernels(g: PoseGraphData, backend: str, group=None) -> bool:
    """`path_takes_kernels` of a graph on its device."""
    return path_takes_kernels(g.poses.device, backend, group, g.n_planes,
                              [getattr(g, t).mask.shape[0]
                               for t in AUX_TABLES])


def build_index(from_idx: np.ndarray, to_idx: np.ndarray, mask: np.ndarray,
                n_nodes: int):
    """The LMIndex of one graph's SE3 table, on the host -> (blocks (K,
    4), codes (C,)) int32 arrays.

    Each block's contributions go in ascending edge order, and an edge's
    slots in ascending order: a node's diagonal block takes slot 0 of
    the edges leaving it and slot 1 of those entering it (all four of a
    self-loop's), a pair's block (a, b), a < b, slot 2 of the edges a ->
    b and slot 3 of those b -> a. Padding rows (mask false) are in no
    block."""
    e = np.flatnonzero(np.asarray(mask, bool)).astype(np.int64)
    f = np.asarray(from_idx, np.int64)[e]
    t = np.asarray(to_idx, np.int64)[e]
    loop = f == t
    off = ~loop
    pairs, inv = np.unique(np.minimum(f, t)[off] * n_nodes
                           + np.maximum(f, t)[off], return_inverse=True)
    nl = int(loop.sum())
    blk = np.concatenate([f, t, f[loop], f[loop], n_nodes + inv.reshape(-1)])
    edge = np.concatenate([e, e, e[loop], e[loop], e[off]])
    slot = np.concatenate([np.zeros(len(e), np.int64),
                           np.ones(len(e), np.int64),
                           np.full(nl, 2), np.full(nl, 3),
                           np.where(f[off] < t[off], 2, 3)])
    order = np.lexsort((slot, edge, blk))
    k = n_nodes + len(pairs)
    counts = np.bincount(blk, minlength=k)
    blocks = np.empty((k, 4), np.int32)
    nodes = np.arange(n_nodes)
    blocks[:, 0] = np.concatenate([nodes, pairs // n_nodes])
    blocks[:, 1] = np.concatenate([nodes, pairs % n_nodes])
    blocks[:, 3] = np.cumsum(counts)
    blocks[:, 2] = blocks[:, 3] - counts
    codes = (edge * 4 + slot)[order].astype(np.int32)
    return blocks, codes if len(codes) else np.zeros(1, np.int32)


def index_from_graph(g: PoseGraphData) -> LMIndex:
    """The LMIndex of a graph on the card, for a caller of the solve that
    did not bring one (GraphSLAM's snapshot brings it from its host
    tables): one read of the SE3 table's indices and mask, one upload."""
    t = g.se3
    e = t.mask.shape[0]
    with profiling.span("read.lm_index"):
        host = torch.cat([t.from_idx.int(), t.to_idx.int(), t.mask.int(),
                          g.node_mask.int()]).cpu().numpy()
        blocks, codes = build_index(host[:e], host[e:2 * e],
                                    host[2 * e:3 * e], g.n_nodes)
        flat = torch.from_numpy(np.concatenate([blocks.ravel(), codes]))
        flat = flat.to(g.poses.device)
    live = np.flatnonzero(host[3 * e:])
    return LMIndex(flat[:blocks.size].view(blocks.shape),
                   flat[blocks.size:], int(live[-1]) + 1 if len(live) else 0)


def _stack_index(indexes: Sequence[LMIndex]) -> LMIndex:
    """Per-graph indexes -> (R, K, 4) and (R, C), padded."""
    if len(indexes) == 1:
        return LMIndex(indexes[0].blocks[None], indexes[0].codes[None],
                       indexes[0].live)
    k = max(i.blocks.shape[0] for i in indexes)
    c = max(i.codes.shape[0] for i in indexes)
    pad = torch.nn.functional.pad
    return LMIndex(
        torch.stack([pad(i.blocks, (0, 0, 0, k - i.blocks.shape[0]),
                         value=-1) for i in indexes]),
        torch.stack([pad(i.codes, (0, c - i.codes.shape[0]))
                     for i in indexes]),
        max(i.live for i in indexes))


class _Batch(NamedTuple):
    """R graphs' inputs and the solve's buffers, contiguous on the card."""

    n: int
    e: int
    from_idx: torch.Tensor  # (R, E) int32
    to_idx: torch.Tensor
    meas: torch.Tensor      # (R, E, 7)
    info: torch.Tensor      # (R, E, 6, 6)
    kernel: torch.Tensor    # (R, E) int32
    delta: torch.Tensor     # (R, E)
    mask: torch.Tensor      # (R, E) bool
    free: torch.Tensor      # (R, N) bool
    index: LMIndex
    poses: torch.Tensor     # (R, N, 7), the solve's own copy
    trial: torch.Tensor     # (R, N, 7)
    contrib: torch.Tensor   # (R, 120, E)
    terms: torch.Tensor     # (R, E) chi2 terms
    Hs: torch.Tensor        # (R, L, L), L = 6 live
    bs: torch.Tensor        # (R, L, 1)
    vecs: torch.Tensor      # (4, R, 6N): s, diag, b, gradient
    state: torch.Tensor     # (6, R): chi2, chi2_0, lam, nu, pred, chi2_new
    flags: torch.Tensor     # (2, R) bool: done, relin
    iters: torch.Tensor     # (R,) int32


def _batch(gs: Sequence[PoseGraphData], index: LMIndex,
           lam0: float) -> _Batch:
    R, n, e = len(gs), gs[0].n_nodes, gs[0].se3.mask.shape[0]
    dev = gs[0].poses.device

    def stack(f, dtype=None):
        x = [f(g) if dtype is None else f(g).to(dtype) for g in gs]
        return (x[0][None] if R == 1 else torch.stack(x)).contiguous()

    poses = stack(lambda g: g.poses)
    if R == 1:
        poses = poses.clone()  # the solve writes its poses in place
    d = 6 * max(index.live, 1)
    state = torch.zeros((6, R), device=dev)
    state[2].fill_(lam0)
    state[3].fill_(2.0)
    flags = torch.zeros((2, R), dtype=torch.bool, device=dev)
    flags[1].fill_(True)
    return _Batch(
        n=n, e=e, from_idx=stack(lambda g: g.se3.from_idx, torch.int32),
        to_idx=stack(lambda g: g.se3.to_idx, torch.int32),
        meas=stack(lambda g: g.se3.meas), info=stack(lambda g: g.se3.info),
        kernel=stack(lambda g: g.se3.kernel, torch.int32),
        delta=stack(lambda g: g.se3.delta), mask=stack(lambda g: g.se3.mask),
        free=stack(lambda g: g.node_mask & ~g.node_fixed), index=index,
        poses=poses, trial=torch.empty_like(poses),
        contrib=torch.empty((R, ROWS, e), device=dev),
        terms=torch.empty((R, e), device=dev),
        Hs=torch.zeros((R, d, d), device=dev),
        bs=torch.empty((R, d, 1), device=dev),
        vecs=torch.empty((4, R, 6 * n), device=dev), state=state,
        flags=flags,
        iters=torch.zeros(R, dtype=torch.int32, device=dev))


def _check(b: _Batch) -> None:
    native.check_cuda_f32(b.poses, b.meas, b.info, b.delta, b.contrib)
    for t in (b.from_idx, b.to_idx, b.kernel, b.mask, b.free, b.index.blocks,
              b.index.codes, b.flags, b.iters):
        if t.device != b.poses.device or not t.is_contiguous():
            raise ValueError("kernel input must be contiguous on the "
                             "poses' CUDA device")


def linearize_cuda(b: _Batch) -> None:
    """mrg_lm_linearize: the edge terms of the graphs whose relin flag is
    set."""
    fn = native.library("lm_dense").mrg_lm_linearize
    with torch.cuda.device(b.poses.device):
        rc = fn(b.poses.data_ptr(), b.from_idx.data_ptr(),
                b.to_idx.data_ptr(), b.meas.data_ptr(), b.info.data_ptr(),
                b.kernel.data_ptr(), b.delta.data_ptr(), b.mask.data_ptr(),
                b.flags[1].data_ptr(), b.poses.shape[0], b.n, b.e,
                b.contrib.data_ptr(), b.terms.data_ptr(),
                native.stream_ptr(b.poses.device))
    native.check_rc(rc, "lm_linearize")
    linearize_cuda.launches += 1


def assemble_cuda(b: _Batch, init: bool) -> None:
    """mrg_lm_assemble: Hs, bs and the vectors of the graphs not done;
    with `init` also chi2 and chi2_0 from the edge terms."""
    fn = native.library("lm_dense").mrg_lm_assemble
    s, d, bv, g = (v.data_ptr() for v in b.vecs)
    with torch.cuda.device(b.poses.device):
        rc = fn(b.contrib.data_ptr(), b.terms.data_ptr(),
                b.index.blocks.data_ptr(), b.index.codes.data_ptr(),
                b.free.data_ptr(), b.state[2].data_ptr(),
                b.flags[0].data_ptr(), b.poses.shape[0], b.n,
                b.Hs.shape[1] // 6, b.e, b.index.blocks.shape[1],
                b.index.codes.shape[1], int(init),
                b.Hs.data_ptr(), b.bs.data_ptr(), s, d, bv, g,
                b.state[0].data_ptr(), b.state[1].data_ptr(),
                native.stream_ptr(b.poses.device))
    native.check_rc(rc, "lm_assemble")
    assemble_cuda.launches += 1


def trial_cuda(b: _Batch, y: torch.Tensor, dy: torch.Tensor,
               chol_info: torch.Tensor, is_lm: bool, rel_tol: float) -> None:
    """mrg_lm_trial: the step of the scaled solution y + dy, its verdict
    and the take, for the graphs not done."""
    fn = native.library("lm_dense").mrg_lm_trial
    s, d, bv, _ = (v.data_ptr() for v in b.vecs)
    st = [b.state[k].data_ptr() for k in range(6)]
    if chol_info.dtype != torch.int32 or not chol_info.is_contiguous():
        raise TypeError("the Cholesky's info must be contiguous int32")
    for v in (y, dy):
        if v.shape != b.bs.shape or v.device != b.bs.device \
                or not v.is_contiguous():
            raise ValueError(f"expected a contiguous {tuple(b.bs.shape)} "
                             f"step on {b.bs.device}, got {tuple(v.shape)}")
    with torch.cuda.device(b.poses.device):
        rc = fn(y.data_ptr(), dy.data_ptr(), s, d, bv, chol_info.data_ptr(),
                b.free.data_ptr(), b.from_idx.data_ptr(),
                b.to_idx.data_ptr(), b.meas.data_ptr(), b.info.data_ptr(),
                b.kernel.data_ptr(), b.delta.data_ptr(), b.mask.data_ptr(),
                b.poses.shape[0], b.n, b.Hs.shape[1] // 6, b.e, int(is_lm),
                float(rel_tol),
                b.poses.data_ptr(), b.trial.data_ptr(), st[0], st[2], st[3],
                b.flags[0].data_ptr(), b.flags[1].data_ptr(),
                b.iters.data_ptr(), st[4], st[5],
                native.stream_ptr(b.poses.device))
    native.check_rc(rc, "lm_trial")
    trial_cuda.launches += 1


linearize_cuda.launches = 0
assemble_cuda.launches = 0
trial_cuda.launches = 0


def _solve_step(b: _Batch):
    """The library's part: Hs = L L^T, y = Hs^-1 bs and one refinement
    dy = Hs^-1 (bs - Hs y) (solve.dense_delta) -> (y, dy, info)."""
    L, info = torch.linalg.cholesky_ex(b.Hs)
    y = torch.cholesky_solve(b.bs, L)
    dy = torch.cholesky_solve(torch.baddbmm(b.bs, b.Hs, y, alpha=-1), L)
    return y.contiguous(), dy.contiguous(), info


def optimize(gs: Sequence[PoseGraphData],
             indexes: Sequence[Optional[LMIndex]],
             cfg: OptimizerConfig) -> Result:
    """The dense LM of `solve.optimize` / `solve.optimize_many` over R
    graphs of one shape that `takes_kernels`, each with its LMIndex (None:
    read off the graph, `index_from_graph`). Same schedule, stop and
    iteration cap; `done` is sticky and freezes a graph; one read of the
    done flags an iteration."""
    is_lm = cfg.g2o_solver_type.startswith("lm")
    index = _stack_index([i if i is not None else index_from_graph(g)
                          for g, i in zip(gs, indexes)])
    b = _batch(gs, index, cfg.lm_initial_lambda if is_lm else 1e-9)
    _check(b)
    if cfg.g2o_solver_num_iterations <= 0:
        # no iteration: the chi2 at the start, as the op path returns it
        linearize_cuda(b)
        assemble_cuda(b, init=True)
    passes = 0
    while passes < cfg.g2o_solver_num_iterations:
        with profiling.span("lm.iteration"):
            linearize_cuda(b)
            assemble_cuda(b, init=passes == 0)
            y, dy, info = _solve_step(b)
            trial_cuda(b, y, dy, info, is_lm, cfg.chi2_rel_tol)
            passes += 1
            # the one host read of the iteration
            with profiling.span("read.lm_iteration"):
                stop = all(b.flags[0].tolist())
            if stop:
                break
    return Result(poses=b.poses, chi2_initial=b.state[1],
                  chi2_final=b.state[0], iterations=b.iters.long(),
                  lambda_final=b.state[2], passes=passes)


# -- the plain twin: the op path's numbers for the kernels' outputs -------

def assemble_plain(g: PoseGraphData, lam: torch.Tensor) -> dict:
    """What linearize + assemble write for one graph at its poses, by
    graph/solve.py's ops: Hs (D, D), bs, s, diag, b, grad (D,), chi2."""
    from . import solve

    lin = solve.linearize(g)
    H, bvec, free = solve.assemble_dense(g, lin)
    Hs, bs, s, diag = solve.equilibrate(H, bvec, free, lam)
    grad = solve.gradient(g, lin)[0].reshape(-1)
    return dict(Hs=Hs, bs=bs[..., 0], s=s, diag=diag, b=bvec, grad=grad,
                chi2=lin.chi2)


def trial_plain(g: PoseGraphData, y: torch.Tensor, s: torch.Tensor,
                diag: torch.Tensor, bvec: torch.Tensor, chi2: torch.Tensor,
                lam: torch.Tensor, nu: torch.Tensor, is_lm: bool,
                rel_tol: float) -> dict:
    """What trial writes for one graph, by graph/solve.py's ops, from the
    refined scaled solution y (D,): the trial poses, pred, the trial's
    chi2, and lam, nu, done and the poses after the verdict."""
    from . import solve

    x = y * s
    pred = torch.sum(x * (lam * diag * x + bvec), dim=-1)
    n = g.n_nodes
    trial = solve._retract_all(g, x.view(n, 6), g.planes.new_zeros((0, 3)))
    chi2_new = solve.chi2_only(trial)
    accept, lam, nu, done = solve._lm_schedule(chi2, chi2_new, pred, lam,
                                               nu, is_lm, rel_tol)
    return dict(trial=trial.poses, pred=pred, chi2_new=chi2_new, lam=lam,
                nu=nu, done=done,
                poses=torch.where(accept, trial.poses, g.poses))
