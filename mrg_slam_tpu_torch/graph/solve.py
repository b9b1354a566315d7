"""Manifold Levenberg-Marquardt for the pose graph: dense, cg or chain.

Counterpart of the JAX package's graph/solve.py (the reference wraps
g2o's sparse LM with cholmod, graph_slam.cpp:353-425). Three linear
solvers behind one LM loop:

- "dense": 6x6 blocks scatter into a (D, D) Hessian, D = 6 N + 3 P, which
  is equilibrated, Cholesky-factored and refined once per step; it also
  gives exact marginals.
- "cg": block-Jacobi preconditioned conjugate gradients on matrix-free
  Hessian-vector products (gather, per-edge 6x6 products, scatter), with
  Eisenstat-Walker forcing; O(E) memory.
- "chain": the segmented block-tridiagonal Cholesky with a Woodbury
  correction for the loop edges (graph/chain_solver.py), exact at any
  size.

Robust kernels enter as IRLS weights at every linearization; fixed nodes
(the anchor) and padding lanes are projected out of the update.

The JAX package runs the LM iterations, and the CG iterations inside
each, in `lax.while_loop`s; here they are Python loops. The LM reads one
flag a iteration (`optimize_many`, the dense LM over R graphs of one
shape side by side, one flag for the whole batch); a CG loop keeps going for every system whose residual
is still above its tolerance, freezes the others where they stopped, and
reads whether any is left every CG_CHECK_EVERY iterations, so it returns
what a loop that stopped at once returns. Vectors over the node pool are
(N, 6, B): B systems side by side, one for a step, 6m for m nodes'
marginals. Scatters go through `index_put_(..., accumulate=True)`, which
PyTorch runs deterministically on the card under
`torch.use_deterministic_algorithms(True)` (runtime.py), so the same graph
gives the same poses bit for bit.

The dense LM of a graph on the card whose only edge family is SE3, on
one device, runs in the hand-written kernels of graph/lm_dense.py
(csrc/lm_dense.cu) instead, which sum in a fixed order without atomics;
every other solve, and every solve on the CPU, runs the ops here.

Every edge family of graph/types.py is solved, over the two node pools:
SE(3) poses (6 dof) and planes (3 dof). A family whose table has zero
capacity is skipped at every stage, as the JAX package's `_has` skips it,
so a pose-only graph pays for its SE3 sweep alone. Vectors of a CG solve
are tuples (node stack (N, 6, B), plane stack (P, 3, B)), the plane stack
left out when the graph has no plane pool.

The functions whose JAX twins take an `axis_name` take a `group`, a
torch.distributed process group (parallel/dist_solver.py): their graph's
edge tables are then one rank's shard, and each reduction over edges
(chi2, the gradient, the diagonal blocks, the dense Hessian, H v) is one
all-reduce over the group, packed where several fall together, so every
rank holds the same sums and takes the same LM decisions. With
`group=None` nothing is reduced and the ops are those of one device.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import torch

from ..config import OptimizerConfig
from ..utils import profiling, se3
from . import edges as E
from . import lm_dense
from .robust import robust_rho_and_weight
from .types import PoseGraphData, plane_retract

# CG iterations between two reads of whether a system is still iterating
CG_CHECK_EVERY = 16


class LinearizedGraph(NamedTuple):
    """Residuals, Jacobians and IRLS-weighted information of each family
    (None for a family whose table has zero capacity)."""

    chi2: torch.Tensor   # () robust chi2
    r_se3: torch.Tensor  # (E, 6)
    Ji: torch.Tensor     # (E, 6, 6)
    Jj: torch.Tensor     # (E, 6, 6)
    W_se3: torch.Tensor  # (E, 6, 6)
    r_pr: Optional[torch.Tensor] = None       # (E, 3) priors
    Jp: Optional[torch.Tensor] = None         # (E, 3, 6)
    W_pr: Optional[torch.Tensor] = None
    r_pl: Optional[torch.Tensor] = None       # (E, 3) SE3-plane edges
    Jpl_pose: Optional[torch.Tensor] = None   # (E, 3, 6)
    Jpl_plane: Optional[torch.Tensor] = None  # (E, 3, 3)
    W_pl: Optional[torch.Tensor] = None
    r_pp: Optional[torch.Tensor] = None       # (E, 4) plane priors
    Jpp: Optional[torch.Tensor] = None        # (E, 4, 3)
    W_pp: Optional[torch.Tensor] = None
    r_qq: Optional[torch.Tensor] = None       # (E, 4) plane-plane edges
    Jqq_a: Optional[torch.Tensor] = None      # (E, 4, 3)
    Jqq_b: Optional[torch.Tensor] = None
    W_qq: Optional[torch.Tensor] = None


class OptimizeResult(NamedTuple):
    poses: torch.Tensor
    planes: torch.Tensor
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor
    iterations: int
    lambda_final: torch.Tensor
    cg_iterations: torch.Tensor  # () CG iterations over the LM (cg only)
    fused: bool = False  # the LM ran graph/lm_dense.py's kernels


def _sum_over(group, *xs):
    """The tensors summed over the ranks of `group`, packed into one
    reduction (the twin of the JAX package's `_psum_if`); with no group,
    the tensors themselves. Every rank gets the same bits.

    A gloo group of a power-of-two size sums by recursive doubling on the
    host (`_doubling_sum`); any other group by one `dist.all_reduce`. A
    ring all_reduce, gloo's, takes 2 (n - 1) message latencies where
    doubling takes log2 n: on one host whose loopback costs ~1 ms a
    message that is the solve's wall (PERF.md §6, PR 12)."""
    if group is None:
        return xs if len(xs) > 1 else xs[0]
    import torch.distributed as dist

    flat = torch.cat([x.reshape(-1) for x in xs])
    n = group.size()
    t0 = time.perf_counter()
    if dist.get_backend(group) == "gloo" and n & (n - 1) == 0:
        flat = _doubling_sum(flat, group)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    _sum_over.calls += 1
    _sum_over.seconds += time.perf_counter() - t0
    out = [v.view(x.shape) for v, x in
           zip(torch.split(flat, [x.numel() for x in xs]), xs)]
    return tuple(out) if len(out) > 1 else out[0]


def _doubling_sum(flat: torch.Tensor, group) -> torch.Tensor:
    """Recursive doubling over a gloo group of 2^m ranks: the tensor is
    read to the host once (gloo reduces a CUDA tensor in host memory
    too), then in round k each rank swaps its partial sum with rank
    (rank XOR 2^k) and adds; a + b and b + a are the same bits, so the
    partners, and after m rounds every rank, hold the same sum. It goes
    back to the tensor's device."""
    import torch.distributed as dist

    host = flat.cpu()
    buf = torch.empty_like(host)
    rank, k = group.rank(), 1
    while k < group.size():
        peer = dist.get_global_rank(group, rank ^ k)
        req = dist.isend(host, peer, group=group)
        dist.recv(buf, peer, group=group)
        req.wait()
        host = host + buf
        k <<= 1
    return host.to(flat.device)


# reductions over a group made in this process, and their host wall (a
# CUDA tensor's read to the host waits for the work queued before it)
_sum_over.calls = 0
_sum_over.seconds = 0.0


def _has(table) -> bool:
    """Whether a family's table has capacity: one of zero capacity adds
    no op to any stage of a solve (the JAX package's `_has`)."""
    return table.mask.shape[0] > 0


def _weighted(info, r, kernel, delta, mask):
    """IRLS effective information and the robust chi2 contribution."""
    e = torch.einsum("ei,eij,ej->e", r, info, r)
    rho, w = robust_rho_and_weight(e, kernel, delta)
    m = mask.to(e.dtype)
    return info * (w * m)[:, None, None], torch.sum(rho * m)


def _aux_terms(g: PoseGraphData):
    """The prior, SE3-plane, plane-prior and plane-plane families of the
    tables with capacity -> (LinearizedGraph fields, their chi2 or
    None)."""
    out, chi2 = {}, None
    fams = (("priors", ("r_pr", "Jp"), "W_pr",
             lambda t: E.prior_edge_terms(g.poses, t)),
            ("plane_edges", ("r_pl", "Jpl_pose", "Jpl_plane"), "W_pl",
             lambda t: E.plane_edge_terms(g.poses, g.planes, t)),
            ("plane_priors", ("r_pp", "Jpp"), "W_pp",
             lambda t: E.plane_prior_terms(g.planes, t)),
            ("plane_plane", ("r_qq", "Jqq_a", "Jqq_b"), "W_qq",
             lambda t: E.plane_plane_terms(g.planes, t)))
    for name, keys, wkey, terms in fams:
        t = getattr(g, name)
        if not _has(t):
            continue
        vals = terms(t)
        W, c = _weighted(t.info, vals[0], t.kernel, t.delta, t.mask)
        out.update(zip(keys, vals))
        out[wkey] = W
        chi2 = c if chi2 is None else chi2 + c
    return out, chi2


def linearize(g: PoseGraphData, group=None) -> LinearizedGraph:
    """Residuals, Jacobians and weights of every edge, and chi2 (summed
    over `group`'s edge shards)."""
    t = g.se3
    if t.mask.shape[0] == 0:
        z = g.poses.new_zeros
        lin = LinearizedGraph(z(()), z((0, 6)), z((0, 6, 6)),
                              z((0, 6, 6)), z((0, 6, 6)))
    else:
        r, Ji, Jj = E.se3_edge_terms(g.poses, t)
        W, chi2 = _weighted(t.info, r, t.kernel, t.delta, t.mask)
        lin = LinearizedGraph(chi2, r, Ji, Jj, W)
    aux, c = _aux_terms(g)
    lin = lin._replace(chi2=lin.chi2 + c, **aux) if aux else lin
    return lin if group is None else lin._replace(
        chi2=_sum_over(group, lin.chi2))


def chi2_only(g: PoseGraphData, group=None) -> torch.Tensor:
    """The robust chi2, without the SE3 family's Jacobians."""
    t = g.se3
    chi2 = g.poses.new_zeros(())
    if t.mask.shape[0]:
        r = se3.pose_error(t.meas, g.poses[t.from_idx], g.poses[t.to_idx])
        chi2 = _weighted(t.info, r, t.kernel, t.delta, t.mask)[1]
    c = _aux_terms(g)[1]
    return _sum_over(group, chi2 if c is None else chi2 + c)


def _free_masks(g: PoseGraphData):
    fn = (g.node_mask & ~g.node_fixed).to(torch.float32)[:, None]
    fp = (g.plane_mask & ~g.plane_fixed).to(torch.float32)[:, None]
    return fn, fp


def _segment_sum(values: torch.Tensor, idx: torch.Tensor,
                 n: int) -> torch.Tensor:
    """sum of values (E, ...) into n rows by idx (E,), deterministically."""
    out = values.new_zeros((n,) + values.shape[1:])
    return out.index_put_((idx.long(),), values, accumulate=True)


def _families(g: PoseGraphData, lin: LinearizedGraph):
    """Each linearized family as (W (E, m, m), r (E, m), ends), an end
    being (pool, node or plane index (E,) int64, J (E, m, d)); pool 0 is
    the SE(3) nodes (d = 6), pool 1 the planes (d = 3)."""
    fams = []
    if lin.r_se3.shape[0]:
        fams.append((lin.W_se3, lin.r_se3,
                     ((0, g.se3.from_idx.long(), lin.Ji),
                      (0, g.se3.to_idx.long(), lin.Jj))))
    if lin.r_pr is not None:
        fams.append((lin.W_pr, lin.r_pr,
                     ((0, g.priors.node_idx.long(), lin.Jp),)))
    if lin.r_pl is not None:
        t = g.plane_edges
        fams.append((lin.W_pl, lin.r_pl,
                     ((0, t.node_idx.long(), lin.Jpl_pose),
                      (1, t.plane_idx.long(), lin.Jpl_plane))))
    if lin.r_pp is not None:
        fams.append((lin.W_pp, lin.r_pp,
                     ((1, g.plane_priors.plane_idx.long(), lin.Jpp),)))
    if lin.r_qq is not None:
        t = g.plane_plane
        fams.append((lin.W_qq, lin.r_qq,
                     ((1, t.from_idx.long(), lin.Jqq_a),
                      (1, t.to_idx.long(), lin.Jqq_b))))
    return fams


def _accumulate(out: list, pool: int, value: torch.Tensor) -> None:
    out[pool] = value if out[pool] is None else out[pool] + value


def gradient(g: PoseGraphData, lin: LinearizedGraph, group=None):
    """J^T W r per node pool, free dofs only: (N, 6), (P, 3)."""
    sizes = (g.n_nodes, g.n_planes)
    acc = [None, None]
    for W, r, ends in _families(g, lin):
        Wr = torch.einsum("eij,ej->ei", W, r)
        for pool, idx, J in ends:
            _accumulate(acc, pool, _segment_sum(
                torch.einsum("eai,ea->ei", J, Wr), idx, sizes[pool]))
    fn, fp = _free_masks(g)
    g_n = g.poses.new_zeros((sizes[0], 6)) if acc[0] is None else acc[0]
    g_p = g.poses.new_zeros((sizes[1], 3)) if acc[1] is None else acc[1]
    g_n, g_p = _sum_over(group, g_n, g_p)
    return g_n * fn, g_p * fp


def block_diagonal(g: PoseGraphData, lin: LinearizedGraph, group=None):
    """Per-node 6x6 and per-plane 3x3 diagonal blocks of H: (N, 6, 6),
    (P, 3, 3)."""
    sizes = (g.n_nodes, g.n_planes)
    D = [lin.W_se3.new_zeros((sizes[0], 6, 6)),
         lin.W_se3.new_zeros((sizes[1], 3, 3))]
    for W, _, ends in _families(g, lin):
        for pool, idx, J in ends:
            D[pool] = D[pool] + _segment_sum(
                torch.einsum("eai,eab,ebj->eij", J, W, J), idx, sizes[pool])
    return _sum_over(group, D[0], D[1])


def make_hvp(g: PoseGraphData, lin: LinearizedGraph, group=None):
    """Matrix-free H @ v over the node pools: per edge u = sum of J v at
    its ends, then J^T W u scattered back to each end; fixed and invalid
    nodes and planes are projected out. v is a tuple (v_n (N, 6, B),
    v_p (P, 3, B)), without v_p when the graph has no plane pool; the
    result is a tuple of the same form, summed over `group` in one
    all-reduce a product."""
    sizes = (g.n_nodes, g.n_planes)
    free = [f[:, :, None] for f in _free_masks(g)]
    fams = [(W, [(pool, idx, J, J.transpose(1, 2)) for pool, idx, J in e])
            for W, _, e in _families(g, lin)]

    def hvp(v):
        v = [x * f for x, f in zip(v, free)]
        out = [None] * len(v)
        for W, ends in fams:
            u = None
            for pool, idx, J, _ in ends:
                Jv = J @ v[pool][idx]
                u = Jv if u is None else u + Jv
            Wu = W @ u
            for pool, idx, _, JT in ends:
                _accumulate(out, pool, _segment_sum(JT @ Wu, idx,
                                                    sizes[pool]))
        if group is not None:
            live = [k for k, o in enumerate(out) if o is not None]
            summed = _sum_over(group, *(out[k] for k in live))
            for k, o in zip(live, summed if len(live) > 1 else (summed,)):
                out[k] = o
        return tuple(torch.zeros_like(x) if o is None else o * f
                     for x, o, f in zip(v, out, free))

    return hvp


def _dot(a, b) -> torch.Tensor:
    """Per-system dot products of two vectors (tuples of (K, d, B)
    stacks) -> (B,)."""
    out = torch.sum(a[0] * b[0], dim=(0, 1))
    for x, y in zip(a[1:], b[1:]):
        out = out + torch.sum(x * y, dim=(0, 1))
    return out


def pcg_solve(A, Minv, b, max_iters: int, tol):
    """Preconditioned CG on A x = b for B systems side by side -> (x,
    iterations (B,)). b is a tuple of stacks, as make_hvp takes them, and
    x takes b's form; A and Minv take and give that form.

    A system iterates while ||r|| > tol ||b|| and fewer than `max_iters`
    iterations ran; once it stops, its x, r, p and rz stay frozen, so each
    column equals a loop run for that system alone (the JAX package's
    vmapped `while_loop`). Whether any system is left is read every
    CG_CHECK_EVERY iterations."""
    def axpy(a, x, y):
        return tuple(xi + a * yi for xi, yi in zip(x, y))

    def where(c, x, y):
        return tuple(torch.where(c, xi, yi) for xi, yi in zip(x, y))

    x = tuple(torch.zeros_like(bi) for bi in b)
    r = b
    p = z = Minv(r)
    rz = _dot(r, z)
    b_norm = torch.sqrt(_dot(r, r)) + 1e-30
    iters = torch.zeros(b[0].shape[-1], dtype=torch.int64,
                        device=b[0].device)
    for i in range(max_iters):
        live = torch.sqrt(_dot(r, r)) > tol * b_norm
        if i % CG_CHECK_EVERY == 0:
            with profiling.span("read.cg_check"):
                left = bool(live.any())
            if not left:
                break
        Ap = A(p)
        alpha = rz / (_dot(p, Ap) + 1e-30)
        x_new = axpy(alpha, x, p)
        r_new = axpy(-alpha, r, Ap)
        z = Minv(r_new)
        rz_new = _dot(r_new, z)
        p_new = axpy(rz_new / (rz + 1e-30), z, p)
        x = where(live, x_new, x)
        r = where(live, r_new, r)
        p = where(live, p_new, p)
        rz = torch.where(live, rz_new, rz)
        iters = iters + live
    return x, iters


def _block_jacobi(D: torch.Tensor, lam, d: torch.Tensor,
                  fn: torch.Tensor):
    """Preconditioner of (H + lam diag(H) + 1e-6) on one pool: the
    inverses of the damped diagonal blocks (D (K, k, k)), fixed and
    invalid members' blocks set to I."""
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    M = _inv_sym(D + (lam * d[..., None] + 1e-6) * eye
                 + (1 - fn[..., None]) * eye, 1e-8)
    return lambda v: M @ v


def _pools(g: PoseGraphData, v: tuple) -> tuple:
    """A CG vector of `g` from (node stack, plane stack): the plane stack
    only when the graph has a plane pool."""
    return tuple(v[:2 if g.n_planes else 1])


def _damped_system(g: PoseGraphData, lin: LinearizedGraph, lam, D=None,
                   group=None):
    """(H + lam diag(H) + 1e-6) v and its block-Jacobi preconditioner
    over the graph's pools -> (A, Minv, diagonals (d_n, d_p)). `D` are
    the diagonal blocks when the caller has them."""
    D = block_diagonal(g, lin) if D is None else D
    d = [torch.diagonal(x, dim1=-2, dim2=-1) for x in D]
    free = _free_masks(g)
    hvp = make_hvp(g, lin, group)
    ridge = [(lam * di + 1e-6)[..., None] for di in d]
    Ms = [_block_jacobi(Di, lam, di, fi) for Di, di, fi in zip(D, d, free)]

    def A(v):
        return tuple(h + rg * x for h, rg, x in zip(hvp(v), ridge, v))

    def Minv(v):
        return tuple(M(x) for M, x in zip(Ms, v))

    return A, Minv, d


def cg_delta(g: PoseGraphData, lin: LinearizedGraph, lam, g0norm,
             cg_max: int, cg_tol: float, group=None):
    """Damped Newton step by block-Jacobi PCG -> (dx_n (N, 6), dx_p (P,
    3), predicted chi2 reduction, gradient inf-norm, CG iterations).

    Eisenstat-Walker forcing: the step is solved only to a tolerance
    proportional to the gradient's progress since the first LM iteration
    (`g0norm`, negative before it), since the next retraction invalidates
    the linearization anyway. With `group`, the gradient and the
    diagonal blocks are summed in one all-reduce, and each H v in one."""
    g_n, g_p = gradient(g, lin)
    D = block_diagonal(g, lin)
    if group is not None:
        g_n, g_p, *D = _sum_over(group, g_n, g_p, *D)
    gnorm = torch.max(torch.abs(g_n))
    if g.n_planes:
        gnorm = torch.maximum(gnorm, torch.max(torch.abs(g_p)))
    A, Minv, (d_n, d_p) = _damped_system(g, lin, lam, D, group)
    eta = torch.clamp(gnorm / torch.clamp(g0norm, min=1e-30), 0.0, 0.1)
    tol = torch.clamp(eta, min=cg_tol)
    x, iters = pcg_solve(A, Minv, _pools(g, (-g_n[..., None],
                                             -g_p[..., None])),
                         cg_max, tol)
    dx_n = x[0][..., 0]
    pred = torch.sum(dx_n * (lam * d_n * dx_n - g_n))
    dx_p = g_p
    if g.n_planes:
        dx_p = x[1][..., 0]
        pred = pred + torch.sum(dx_p * (lam * d_p * dx_p - g_p))
    return dx_n, dx_p, pred, gnorm, iters[0]


def assemble_dense(g: PoseGraphData, lin: LinearizedGraph, group=None):
    """Full (D, D) Hessian, (D,) right-hand side -J^T W r and the (D,)
    free-dof mask; D = 6 N + 3 P, the planes' dofs after the nodes'.
    Fixed and invalid dofs get zero rows and columns and a unit
    diagonal. With `group` the shards' Hessians and gradients are summed
    in one all-reduce."""
    n, p = g.n_nodes, g.n_planes
    D = 6 * n + 3 * p
    H = g.poses.new_zeros(D * D)
    idx, val = [], []
    base = (0, 6 * n)
    for W, _, ends in _families(g, lin):
        dofs = []
        for pool, i, J in ends:
            d = J.shape[-1]
            dofs.append(base[pool] + i[:, None] * d
                        + torch.arange(d, device=H.device))
        WJ = [W @ J for _, _, J in ends]
        for (_, _, Ja), ra in zip(ends, dofs):
            JaT = Ja.transpose(1, 2)
            for WJb, cb in zip(WJ, dofs):
                idx.append((ra[:, :, None] * D + cb[:, None, :]).reshape(-1))
                val.append((JaT @ WJb).reshape(-1))
    if idx:
        H.index_put_((torch.cat(idx),), torch.cat(val), accumulate=True)
    H = H.view(D, D)
    g_n, g_p = gradient(g, lin)
    if group is not None:
        H, g_n, g_p = _sum_over(group, H, g_n, g_p)
    b = -torch.cat([g_n.reshape(-1), g_p.reshape(-1)])
    fn, fp = _free_masks(g)
    free = torch.cat([fn[:, 0].repeat_interleave(6),
                      fp[:, 0].repeat_interleave(3)])
    H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    return H, b * free, free


def _cholesky(A: torch.Tensor):
    """Lower Cholesky factor of A (..., D, D) without the singularity
    check's host sync; a matrix that is not positive definite gives a NaN
    factor, as JAX's cho_factor does."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info[..., None, None] == 0, L,
                       torch.full_like(L, float("nan")))


def equilibrate(H, b, free, lam):
    """The damped system (H + (lam diag(H) + 1e-6) on the free dofs),
    Jacobi-equilibrated -> (Hs, bs (..., D, 1), the scales s, diag(H)),
    for one system or a batch (leading axes, lam (R,))."""
    lam = lam[..., None]
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    Hl = H + torch.diag_embed((lam * diag + 1e-6) * free)
    s = torch.rsqrt(torch.clamp(torch.diagonal(Hl, dim1=-2, dim2=-1),
                                min=1e-12))
    Hs = Hl * s[..., :, None] * s[..., None, :]
    return Hs, (b * s)[..., None], s, diag


def dense_delta(H, b, free, lam):
    """Damped Newton step -> (x, predicted chi2 reduction), for one system
    (H (D, D), b and free (D,), lam ()) or a batch of them (leading
    axes on every argument, lam (R,)).

    f32 Cholesky of a raw pose-graph Hessian (condition 1e6 and more)
    loses enough precision to stall LM; symmetric Jacobi equilibration and
    one step of iterative refinement recover the step (graph/solve.py of
    the JAX package, which factors the upper triangle; the lower factor
    here is the same matrix, rounded differently)."""
    Hs, bs, s, diag = equilibrate(H, b, free, lam)
    lam = lam[..., None]
    L = _cholesky(Hs)
    y = torch.cholesky_solve(bs, L)
    y = y + torch.cholesky_solve(bs - Hs @ y, L)
    x = y[..., 0] * s
    # predicted chi2 reduction of the damped step (g2o's LM rho
    # denominator): dx^T (lam D dx + b)
    return x, torch.sum(x * (lam * diag * x + b), dim=-1)


def _retract_all(g: PoseGraphData, dx_n: torch.Tensor,
                 dx_p: torch.Tensor) -> PoseGraphData:
    """Retract the free nodes and planes; fixed and invalid ones stay."""
    fn, fp = _free_masks(g)
    poses = torch.where(fn > 0, se3.pose_retract(g.poses, dx_n), g.poses)
    if not g.n_planes:
        return g._replace(poses=poses)
    planes = torch.where(fp > 0, plane_retract(g.planes, dx_p), g.planes)
    return g._replace(poses=poses, planes=planes)


def resolve_backend(backend: str, n_nodes: int, n_planes: int = 0,
                    max_dofs: int = 12288) -> str:
    """"auto" -> dense while 6N+3P <= max_dofs, chain beyond, so a graph
    that outgrows the dense Hessian switches to the exact large-graph
    path (g2o's cholmod takes any size); `max_dofs` comes from
    OptimizerConfig.auto_dense_max_dofs."""
    if backend == "auto":
        return "dense" if 6 * n_nodes + 3 * n_planes <= max_dofs \
            else "chain"
    if backend not in ("dense", "cg", "chain"):
        raise ValueError(f"unknown solver backend {backend!r}")
    return backend


def chain_aux_for(g: PoseGraphData):
    """The chain backend's coupling classification of a graph on the
    device (one read of its SE3 table's indices and mask)."""
    from .chain_solver import classify
    t = g.se3
    return classify(t.from_idx.cpu().numpy(), t.to_idx.cpu().numpy(),
                    t.mask.cpu().numpy(), g.plane_edges.mask.shape[0],
                    g.plane_plane.mask.shape[0],
                    pl_mask=g.plane_edges.mask.cpu().numpy(),
                    qq_mask=g.plane_plane.mask.cpu().numpy())


def _chain_K(n: int, n_shards: int = 1) -> int:
    """Segment length of the chain backend: the largest power of two up
    to 64 that divides the node capacity (capacities are powers of two)
    into a segment count that `n_shards` ranks split evenly (the JAX
    package's `_chain_K` and, for n_shards > 1, `_chain_K_dist`)."""
    k = 64
    while k > 2 and (n % k or (n // k) % n_shards):
        k //= 2
    if n_shards > 1 and (n // k) % n_shards:
        raise ValueError(f"node capacity {n} cannot split {n // k} segments "
                         f"over {n_shards} devices — use a power-of-two "
                         "capacity")
    return k


def _lm_schedule(chi2, chi2_new, pred, lam, nu, is_lm: bool,
                 rel_tol: float, done=None):
    """One LM step's verdict -> (accept, next lam, next nu, done): the
    step is taken when it does not raise chi2; Nielsen's gain-ratio
    schedule moves lam (LM solver types only); the solve is done when an
    accepted step improves chi2 by less than `rel_tol` relative, or lam
    passes 1e8. With `done` ((R,) bool, the batched LM) a graph already
    done is frozen: it takes no step and keeps its lam and nu, as the JAX
    package's vmapped body holds it (solve.py:600-700)."""
    accept = chi2_new <= chi2
    if done is not None:
        accept = accept & ~done
    lam_next, nu_next = lam, nu
    if is_lm:
        rho = (chi2 - chi2_new) / torch.clamp(pred, min=1e-30)
        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_next = torch.where(accept, torch.clamp(lam * shrink, min=1e-12),
                               torch.clamp(lam * nu, max=1e10))
        nu_next = torch.where(accept, torch.full_like(nu, 2.0),
                              torch.clamp(nu * 2.0, max=1e8))
        if done is not None:
            lam_next = torch.where(done, lam, lam_next)
            nu_next = torch.where(done, nu, nu_next)
    rel_improve = (chi2 - chi2_new) / torch.clamp(chi2, min=1e-12)
    done_now = (accept & (rel_improve < rel_tol)) | (lam_next > 1e8)
    if done is not None:
        done_now = done_now | done
    return accept, lam_next, nu_next, done_now


def _take(accept, g_new: PoseGraphData, lin_new: LinearizedGraph,
          g: PoseGraphData, lin: LinearizedGraph):
    """The trial point and its linearization where `accept` (a 0-dim
    bool), else the current ones."""
    g = g._replace(poses=torch.where(accept, g_new.poses, g.poses),
                   planes=torch.where(accept, g_new.planes, g.planes))
    lin = LinearizedGraph(*(a if a is None else torch.where(accept, a, c)
                            for a, c in zip(lin_new, lin)))
    return g, lin


def optimize(g: PoseGraphData, cfg: OptimizerConfig,
             aux=None, group=None,
             index: Optional[lm_dense.LMIndex] = None) -> OptimizeResult:
    """Levenberg-Marquardt with chi2-based accept/reject and Nielsen's
    lambda schedule, at most `g2o_solver_num_iterations` iterations;
    `gn_*` solver types run with a fixed tiny damping.

    The chain backend needs the coupling classification `aux`
    (chain_solver.classify); without one it is read off the graph. A
    chain step whose factorization fails raises RuntimeError.

    With a process `group` the loop runs SPMD on every rank of it (the
    JAX package's `_optimize_body` under shard_map): for dense and cg, `g`
    holds this rank's shard of each edge table and every reduction over
    edges is an all-reduce; for chain, `g` is the whole graph on every
    rank and the factorization's segment panels are split over the ranks
    (chain_solver.chain_delta). Node state and every LM decision are
    replicated, so each rank returns the same poses.

    A graph that `lm_dense.takes_kernels` (dense, one device, on the
    card, SE3 edges only) runs the same LM in graph/lm_dense.py's
    kernels, with `index` its LMIndex when the caller built one."""
    from . import chain_solver
    backend = resolve_backend(cfg.solver_backend, g.n_nodes, g.n_planes,
                              cfg.auto_dense_max_dofs)
    if lm_dense.takes_kernels(g, backend, group):
        with profiling.span("lm"):
            res = lm_dense.optimize([g], [index], cfg)
        return OptimizeResult(
            poses=res.poses[0], planes=g.planes,
            chi2_initial=res.chi2_initial[0], chi2_final=res.chi2_final[0],
            iterations=res.passes, lambda_final=res.lambda_final[0],
            cg_iterations=torch.zeros((), dtype=torch.int64,
                                      device=g.poses.device), fused=True)
    is_lm = cfg.g2o_solver_type.startswith("lm")
    n, p = g.n_nodes, g.n_planes
    dev = g.poses.device
    n_shards = 1 if group is None else group.size()
    edge_group = group
    if backend == "chain":
        K = _chain_K(n, n_shards)
        aux = chain_solver.aux_to(aux if aux is not None
                                  else chain_aux_for(g), dev)
        edge_group = None  # the graph is whole on every rank
    # one linearization per iteration: an accepted step hands its trial
    # linearization on, a rejected one keeps the current
    with profiling.span("lm"):
        lin = linearize(g, edge_group)
        chi2_0 = chi2 = lin.chi2
        lam = torch.full((), cfg.lm_initial_lambda if is_lm else 1e-9,
                         device=dev)
        nu = torch.full_like(lam, 2.0)
        g0norm = torch.full_like(lam, -1.0)
        cg_iters = torch.zeros((), dtype=torch.int64, device=dev)
        failed = torch.zeros((), dtype=torch.bool, device=dev)
        it = 0
        while it < cfg.g2o_solver_num_iterations:
            with profiling.span("lm.iteration"):
                if backend == "dense":
                    H, b, free = assemble_dense(g, lin, group)
                    x, pred = dense_delta(H, b, free, lam)
                    dx_n = x[:6 * n].view(n, 6)
                    dx_p = x[6 * n:].view(p, 3)
                elif backend == "chain":
                    dx_n, dx_p, pred, ok = chain_solver.chain_delta(
                        g, lin, lam, aux, K, group, n_shards)
                    failed = ~ok
                else:
                    dx_n, dx_p, pred, gnorm, k = cg_delta(
                        g, lin, lam, g0norm, cfg.cg_max_iterations,
                        cfg.cg_tol, group)
                    g0norm = torch.where(g0norm < 0, gnorm, g0norm)
                    cg_iters = cg_iters + k
                g_new = _retract_all(g, dx_n, dx_p)
                lin_new = linearize(g_new, edge_group)
                chi2_new = lin_new.chi2
                accept, lam, nu, done = _lm_schedule(
                    chi2, chi2_new, pred, lam, nu, is_lm, cfg.chi2_rel_tol)
                g, lin = _take(accept, g_new, lin_new, g, lin)
                chi2 = torch.where(accept, chi2_new, chi2)
                it += 1
                # the one host read of the iteration
                with profiling.span("read.lm_iteration"):
                    stop, bad = torch.stack([done, failed]).tolist()
                if bad:
                    raise RuntimeError(
                        "chain solve: a segment or separator factorization "
                        f"failed in LM iteration {it}")
                if stop:
                    break
    return OptimizeResult(poses=g.poses, planes=g.planes,
                          chi2_initial=chi2_0, chi2_final=chi2,
                          iterations=it, lambda_final=lam,
                          cg_iterations=cg_iters)


def optimize_many(gs: Sequence[PoseGraphData], cfg: OptimizerConfig,
                  indexes: Optional[Sequence[Optional[lm_dense.LMIndex]]]
                  = None) -> OptimizeResult:
    """The dense LM of `optimize` over R graphs of one shape side by side
    (the counterpart of the JAX package's `_optimize_many_split`, a
    vmapped `optimize`) -> an OptimizeResult with a leading graph axis:
    poses (R, N, 7), planes (R, P, 4), chi2, lam and iterations (R,).

    lam, nu, chi2 and done are (R,) tensors. Each iteration linearizes and
    assembles each graph's Hessian, factors the (R, D, D) stack with one
    batched Cholesky, and decides every graph's step, lam and stop at
    once; `done` is sticky and freezes its graph (no step, lam and nu
    kept), so a graph that stops early holds its result while the others
    iterate, and each graph ends where its own `optimize` ends. The batch
    reads one flag an iteration, whether every graph is done.

    When every graph `lm_dense.takes_kernels`, the batch runs
    graph/lm_dense.py's kernels over a leading graph axis, with
    `indexes` their LMIndexes where the caller built them."""
    if resolve_backend(cfg.solver_backend, gs[0].n_nodes, gs[0].n_planes,
                       cfg.auto_dense_max_dofs) != "dense":
        raise ValueError("optimize_many runs the dense backend; solve "
                         "graphs of the other backends one by one")
    gs = list(gs)
    R, n, p = len(gs), gs[0].n_nodes, gs[0].n_planes
    if all(lm_dense.takes_kernels(g, "dense") for g in gs):
        with profiling.span("lm"):
            res = lm_dense.optimize(gs, indexes or [None] * R, cfg)
        return OptimizeResult(
            poses=res.poses, planes=torch.stack([g.planes for g in gs]),
            chi2_initial=res.chi2_initial, chi2_final=res.chi2_final,
            iterations=res.iterations, lambda_final=res.lambda_final,
            cg_iterations=torch.zeros_like(res.iterations), fused=True)
    dev = gs[0].poses.device
    is_lm = cfg.g2o_solver_type.startswith("lm")
    with profiling.span("lm"):
        lins = [linearize(g) for g in gs]
        chi2_0 = chi2 = torch.stack([lin.chi2 for lin in lins])
        lam = torch.full((R,), cfg.lm_initial_lambda if is_lm else 1e-9,
                         device=dev)
        nu = torch.full_like(lam, 2.0)
        done = torch.zeros(R, dtype=torch.bool, device=dev)
        iters = torch.zeros(R, dtype=torch.int64, device=dev)
        for _ in range(cfg.g2o_solver_num_iterations):
            with profiling.span("lm.iteration"):
                systems = [assemble_dense(g, lin)
                           for g, lin in zip(gs, lins)]
                x, pred = dense_delta(
                    *(torch.stack(t) for t in zip(*systems)), lam)
                trials = [_retract_all(g, x[r, :6 * n].view(n, 6),
                                       x[r, 6 * n:].view(p, 3))
                          for r, g in enumerate(gs)]
                lins_new = [linearize(t) for t in trials]
                chi2_new = torch.stack([lin.chi2 for lin in lins_new])
                accept, lam, nu, done_now = _lm_schedule(
                    chi2, chi2_new, pred, lam, nu, is_lm, cfg.chi2_rel_tol,
                    done)
                gs, lins = map(list, zip(*(
                    _take(accept[r], trials[r], lins_new[r], gs[r], lins[r])
                    for r in range(R))))
                chi2 = torch.where(accept, chi2_new, chi2)
                iters = iters + (~done).long()
                done = done_now
                # the one host read of the iteration
                with profiling.span("read.lm_iteration"):
                    stop = bool(done.all())
                if stop:
                    break
    return OptimizeResult(poses=torch.stack([g.poses for g in gs]),
                          planes=torch.stack([g.planes for g in gs]),
                          chi2_initial=chi2_0, chi2_final=chi2,
                          iterations=iters, lambda_final=lam,
                          cg_iterations=torch.zeros_like(iters))


def _inv_sym(blocks: torch.Tensor, ridge: float) -> torch.Tensor:
    eye = torch.eye(blocks.shape[-1], dtype=blocks.dtype,
                    device=blocks.device)
    return torch.linalg.solve_ex(blocks + ridge * eye,
                                 eye.expand(blocks.shape)).result


def marginals(g: PoseGraphData, exact: bool = True) -> torch.Tensor:
    """Per-node 6x6 covariance blocks, the diagonal of H^-1: (N, 6, 6).

    exact=True inverts the dense Hessian (planes included) through its
    Cholesky factor (g2o's sparse marginals, graph_slam.cpp:401-425, at
    dense cost); exact=False inverts the node diagonal blocks
    (block-Jacobi). Fixed and invalid nodes get zero covariance."""
    lin = linearize(g)
    fn, _ = _free_masks(g)
    n = g.n_nodes
    if exact:
        H, _, _ = assemble_dense(g, lin)
        eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
        Hinv = torch.cholesky_solve(eye, _cholesky(H + 1e-9 * eye))
        cov = Hinv[:6 * n, :6 * n].reshape(n, 6, n, 6).diagonal(
            dim1=0, dim2=2).permute(2, 0, 1)
    else:
        cov = _inv_sym(block_diagonal(g, lin)[0], 1e-6)
    return cov * fn[:, :, None]


def marginals_many(gs: Sequence[PoseGraphData],
                   exact: bool = True) -> torch.Tensor:
    """`marginals` of R graphs of one shape -> (R, N, 6, 6) (the JAX
    package's `marginals_many`): each graph's Hessian assembled, then one
    batched Cholesky inverse of the (R, D, D) stack; exact=False inverts
    each graph's node diagonal blocks."""
    if not exact:
        return torch.stack([marginals(g, exact=False) for g in gs])
    n = gs[0].n_nodes
    H = torch.stack([assemble_dense(g, linearize(g))[0] for g in gs])
    fn = torch.stack([_free_masks(g)[0] for g in gs])
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    Hinv = torch.cholesky_solve(eye.expand(H.shape),
                                _cholesky(H + 1e-9 * eye))
    cov = Hinv[:, :6 * n, :6 * n].reshape(-1, n, 6, n, 6).diagonal(
        dim1=1, dim2=3).permute(0, 3, 1, 2)
    return cov * fn[..., None]


def marginals_selected(g: PoseGraphData, node_idx: torch.Tensor,
                       cg_max: Optional[int] = None, cg_tol: float = 1e-9
                       ) -> torch.Tensor:
    """Exact 6x6 covariance blocks of the selected nodes, matrix-free:
    H x = e for the 6 basis vectors of each selected node, solved by
    block-Jacobi PCG as 6m systems side by side (each stops on its own
    residual), then cov[a, b] = e_a^T H^-1 e_b. g2o's sparse selected
    marginals (graph_slam.cpp:401-425) without forming H.

    The system is H + 1e-6 I on the free dofs, planes included (the chain
    marginals' too; the dense path's ridge is 1e-9). CG runs at most
    `cg_max` iterations, by default the system's size 6 N + 3 P (where
    CG ends in exact arithmetic) and no fewer than the JAX package's fixed
    400, which leave full SLAM's 152-keyframe graph unconverged
    (ROADMAP.md §3 B6).

    node_idx: (m,) node ids -> (m, 6, 6); fixed and invalid nodes get
    zero covariance, as in `marginals`."""
    lin = linearize(g)
    fn, _ = _free_masks(g)
    A, Minv, _ = _damped_system(g, lin, 0.0)
    n, p, m = g.n_nodes, g.n_planes, node_idx.shape[0]
    idx = node_idx.long()
    cols = torch.arange(6 * m, device=g.poses.device)
    rhs = g.poses.new_zeros((n, 6, 6 * m))
    rhs[idx.repeat_interleave(6), cols % 6, cols] = 1.0
    # lam = 0; the 1e-6 ridge keeps unconstrained dofs bounded
    X, _ = pcg_solve(A, Minv, _pools(g, (rhs * fn[:, :, None],
                                         rhs.new_zeros((p, 3, 6 * m)))),
                     cg_max if cg_max is not None
                     else max(400, 6 * n + 3 * p), cg_tol)
    cov = X[0][idx].view(m, 6, m, 6).diagonal(dim1=0, dim2=2).permute(
        2, 1, 0)
    return cov * fn[idx][:, :, None]


def resolve_marginals_mode(mode: str, n_nodes: int, n_planes: int = 0
                           ) -> str:
    """"auto" -> exact dense H^-1 up to 4096 dofs, the batched-CG selected
    inverse beyond, so large graphs never pay O(D^3)."""
    if mode == "auto":
        return "exact" if 6 * n_nodes + 3 * n_planes <= 4096 else "cg"
    return mode
