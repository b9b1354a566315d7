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
flag a iteration; a CG loop keeps going for every system whose residual
is still above its tolerance, freezes the others where they stopped, and
reads whether any is left every CG_CHECK_EVERY iterations, so it returns
what a loop that stopped at once returns. Vectors over the node pool are
(N, 6, B): B systems side by side, one for a step, 6m for m nodes'
marginals. Scatters go through `index_put_(..., accumulate=True)`, which
PyTorch runs deterministically on the card under
`torch.use_deterministic_algorithms(True)` (runtime.py), so the same graph
gives the same poses bit for bit.

Only the SE3-SE3 family is ported: a graph whose prior, plane or
plane-plane table holds an edge, or which has a plane node, raises
NotImplementedError (ROADMAP.md queue 1 item 12); tables of zero capacity
or without a live edge are elided.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import OptimizerConfig
from ..utils import se3
from .edges import se3_edge_terms
from .robust import robust_rho_and_weight
from .types import PoseGraphData

# CG iterations between two reads of whether a system is still iterating
CG_CHECK_EVERY = 16


class LinearizedGraph(NamedTuple):
    chi2: torch.Tensor   # () robust chi2
    r_se3: torch.Tensor  # (E, 6)
    Ji: torch.Tensor     # (E, 6, 6)
    Jj: torch.Tensor     # (E, 6, 6)
    W_se3: torch.Tensor  # (E, 6, 6) IRLS-weighted information


class OptimizeResult(NamedTuple):
    poses: torch.Tensor
    planes: torch.Tensor
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor
    iterations: int
    lambda_final: torch.Tensor
    cg_iterations: torch.Tensor  # () CG iterations over the LM (cg only)


def check_families(g: PoseGraphData) -> None:
    """Refuse what only the unported families could solve. A table of
    zero capacity costs nothing; one with capacity is read once (a host
    read, off the main path, whose graphs have none)."""
    for name in ("priors", "plane_edges", "plane_priors", "plane_plane"):
        mask = getattr(g, name).mask
        if mask.shape[0] and bool(mask.any()):
            raise NotImplementedError(
                f"{name} edges are not ported yet: the prior and plane "
                "families wait for ROADMAP.md queue 1 item 12")
    if g.plane_mask.shape[0] and bool(g.plane_mask.any()):
        raise NotImplementedError(
            "plane nodes are not ported yet: they wait for ROADMAP.md "
            "queue 1 item 12")


def _weighted(info, r, kernel, delta, mask):
    """IRLS effective information and the robust chi2 contribution."""
    e = torch.einsum("ei,eij,ej->e", r, info, r)
    rho, w = robust_rho_and_weight(e, kernel, delta)
    m = mask.to(e.dtype)
    return info * (w * m)[:, None, None], torch.sum(rho * m)


def linearize(g: PoseGraphData) -> LinearizedGraph:
    """Residuals, Jacobians and weights of every SE3 edge, and chi2."""
    t = g.se3
    if t.mask.shape[0] == 0:
        z = g.poses.new_zeros
        return LinearizedGraph(z(()), z((0, 6)), z((0, 6, 6)),
                               z((0, 6, 6)), z((0, 6, 6)))
    r, Ji, Jj = se3_edge_terms(g.poses, t)
    W, chi2 = _weighted(t.info, r, t.kernel, t.delta, t.mask)
    return LinearizedGraph(chi2, r, Ji, Jj, W)


def chi2_only(g: PoseGraphData) -> torch.Tensor:
    """The robust chi2 from the residuals alone (no Jacobians)."""
    t = g.se3
    if t.mask.shape[0] == 0:
        return g.poses.new_zeros(())
    r = se3.pose_error(t.meas, g.poses[t.from_idx], g.poses[t.to_idx])
    return _weighted(t.info, r, t.kernel, t.delta, t.mask)[1]


def _free_masks(g: PoseGraphData):
    fn = (g.node_mask & ~g.node_fixed).to(torch.float32)[:, None]
    fp = (g.plane_mask & ~g.plane_fixed).to(torch.float32)[:, None]
    return fn, fp


def _segment_sum(values: torch.Tensor, idx: torch.Tensor,
                 n: int) -> torch.Tensor:
    """sum of values (E, ...) into n rows by idx (E,), deterministically."""
    out = values.new_zeros((n,) + values.shape[1:])
    return out.index_put_((idx.long(),), values, accumulate=True)


def gradient(g: PoseGraphData, lin: LinearizedGraph):
    """J^T W r per node pool, free dofs only: (N, 6), (P, 3)."""
    n = g.n_nodes
    g_n = g.poses.new_zeros((n, 6))
    if lin.r_se3.shape[0]:
        Wr = torch.einsum("eij,ej->ei", lin.W_se3, lin.r_se3)
        g_n = (_segment_sum(torch.einsum("eai,ea->ei", lin.Ji, Wr),
                            g.se3.from_idx, n)
               + _segment_sum(torch.einsum("eai,ea->ei", lin.Jj, Wr),
                              g.se3.to_idx, n))
    fn, _ = _free_masks(g)
    return g_n * fn, g.poses.new_zeros((g.n_planes, 3))


def block_diagonal(g: PoseGraphData, lin: LinearizedGraph) -> torch.Tensor:
    """Per-node 6x6 diagonal blocks of H: (N, 6, 6)."""
    n = g.n_nodes
    D = g.poses.new_zeros((n, 6, 6))
    if lin.r_se3.shape[0]:
        for J, idx in ((lin.Ji, g.se3.from_idx), (lin.Jj, g.se3.to_idx)):
            D = D + _segment_sum(
                torch.einsum("eai,eab,ebj->eij", J, lin.W_se3, J), idx, n)
    return D


def make_hvp(g: PoseGraphData, lin: LinearizedGraph):
    """Matrix-free H @ v over the node pool, v (N, 6, B) -> (N, 6, B):
    per edge u = J_from v_from + J_to v_to, then J^T W u scattered back
    to both ends; fixed and invalid nodes are projected out."""
    n = g.n_nodes
    fn = _free_masks(g)[0][:, :, None]
    f, t = g.se3.from_idx.long(), g.se3.to_idx.long()
    Ji, Jj, W = lin.Ji, lin.Jj, lin.W_se3
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)

    def hvp(v: torch.Tensor) -> torch.Tensor:
        v = v * fn
        if not lin.r_se3.shape[0]:
            return torch.zeros_like(v)
        Wu = W @ (Ji @ v[f] + Jj @ v[t])
        return (_segment_sum(JiT @ Wu, f, n)
                + _segment_sum(JjT @ Wu, t, n)) * fn

    return hvp


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-system dot products of (N, 6, B) stacks -> (B,)."""
    return torch.sum(a * b, dim=(0, 1))


def pcg_solve(A, Minv, b: torch.Tensor, max_iters: int, tol):
    """Preconditioned CG on A x = b for B systems side by side, b (N, 6,
    B) -> (x, iterations (B,)).

    A system iterates while ||r|| > tol ||b|| and fewer than `max_iters`
    iterations ran; once it stops, its x, r, p and rz stay frozen, so each
    column equals a loop run for that system alone (the JAX package's
    vmapped `while_loop`). Whether any system is left is read every
    CG_CHECK_EVERY iterations."""
    x = torch.zeros_like(b)
    r = b
    p = z = Minv(r)
    rz = _dot(r, z)
    b_norm = torch.sqrt(_dot(r, r)) + 1e-30
    iters = torch.zeros(b.shape[-1], dtype=torch.int64, device=b.device)
    for i in range(max_iters):
        live = torch.sqrt(_dot(r, r)) > tol * b_norm
        if i % CG_CHECK_EVERY == 0 and not bool(live.any()):
            break
        Ap = A(p)
        alpha = rz / (_dot(p, Ap) + 1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = Minv(r_new)
        rz_new = _dot(r_new, z)
        p_new = z + (rz_new / (rz + 1e-30)) * p
        x = torch.where(live, x_new, x)
        r = torch.where(live, r_new, r)
        p = torch.where(live, p_new, p)
        rz = torch.where(live, rz_new, rz)
        iters = iters + live
    return x, iters


def _block_jacobi(D: torch.Tensor, lam, d: torch.Tensor,
                  fn: torch.Tensor):
    """Preconditioner of (H + lam diag(H) + 1e-6): the inverses of the
    damped diagonal blocks, fixed and invalid nodes' blocks set to I."""
    eye6 = torch.eye(6, dtype=D.dtype, device=D.device)
    M = _inv_sym(D + (lam * d[..., None] + 1e-6) * eye6
                 + (1 - fn[..., None]) * eye6, 1e-8)
    return lambda v: M @ v


def cg_delta(g: PoseGraphData, lin: LinearizedGraph, lam, g0norm,
             cg_max: int, cg_tol: float):
    """Damped Newton step by block-Jacobi PCG -> (dx (N, 6), predicted
    chi2 reduction, gradient inf-norm, CG iterations).

    Eisenstat-Walker forcing: the step is solved only to a tolerance
    proportional to the gradient's progress since the first LM iteration
    (`g0norm`, negative before it), since the next retraction invalidates
    the linearization anyway."""
    D = block_diagonal(g, lin)
    d = torch.diagonal(D, dim1=-2, dim2=-1)
    g_n, _ = gradient(g, lin)
    gnorm = torch.max(torch.abs(g_n))
    fn, _ = _free_masks(g)
    hvp = make_hvp(g, lin)
    ridge = (lam * d + 1e-6)[..., None]
    eta = torch.clamp(gnorm / torch.clamp(g0norm, min=1e-30), 0.0, 0.1)
    tol = torch.clamp(eta, min=cg_tol)
    x, iters = pcg_solve(lambda v: hvp(v) + ridge * v,
                         _block_jacobi(D, lam, d, fn), -g_n[..., None],
                         cg_max, tol)
    dx = x[..., 0]
    return dx, torch.sum(dx * (lam * d * dx - g_n)), gnorm, iters[0]


def assemble_dense(g: PoseGraphData, lin: LinearizedGraph):
    """Full (D, D) Hessian, (D,) right-hand side -J^T W r and the (D,)
    free-dof mask; D = 6 N + 3 P. Fixed and invalid dofs get zero rows
    and columns and a unit diagonal."""
    n, p = g.n_nodes, g.n_planes
    D = 6 * n + 3 * p
    H = g.poses.new_zeros(D * D)
    if lin.r_se3.shape[0]:
        ar6 = torch.arange(6, device=H.device)
        fi = g.se3.from_idx.long()[:, None] * 6 + ar6
        ti = g.se3.to_idx.long()[:, None] * 6 + ar6
        WJi = lin.W_se3 @ lin.Ji
        WJj = lin.W_se3 @ lin.Jj
        JiT, JjT = lin.Ji.transpose(1, 2), lin.Jj.transpose(1, 2)
        idx, val = [], []
        for rows, cols, blk in ((fi, fi, JiT @ WJi), (fi, ti, JiT @ WJj),
                                (ti, fi, JjT @ WJi), (ti, ti, JjT @ WJj)):
            idx.append((rows[:, :, None] * D + cols[:, None, :]).reshape(-1))
            val.append(blk.reshape(-1))
        H.index_put_((torch.cat(idx),), torch.cat(val), accumulate=True)
    H = H.view(D, D)
    g_n, g_p = gradient(g, lin)
    b = -torch.cat([g_n.reshape(-1), g_p.reshape(-1)])
    fn, fp = _free_masks(g)
    free = torch.cat([fn[:, 0].repeat_interleave(6),
                      fp[:, 0].repeat_interleave(3)])
    H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    return H, b * free, free


def _cholesky(A: torch.Tensor):
    """Lower Cholesky factor without the singularity check's host sync;
    a matrix that is not positive definite gives a NaN factor, as JAX's
    cho_factor does."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def dense_delta(H, b, free, lam):
    """Damped Newton step -> (x, predicted chi2 reduction).

    f32 Cholesky of a raw pose-graph Hessian (condition 1e6 and more)
    loses enough precision to stall LM; symmetric Jacobi equilibration and
    one step of iterative refinement recover the step (graph/solve.py of
    the JAX package, which factors the upper triangle; the lower factor
    here is the same matrix, rounded differently)."""
    diag = torch.diagonal(H)
    Hl = H + torch.diag((lam * diag + 1e-6) * free)
    s = torch.rsqrt(torch.clamp(torch.diagonal(Hl), min=1e-12))
    Hs = Hl * s[:, None] * s[None, :]
    bs = (b * s)[:, None]
    L = _cholesky(Hs)
    y = torch.cholesky_solve(bs, L)
    y = y + torch.cholesky_solve(bs - Hs @ y, L)
    x = y[:, 0] * s
    # predicted chi2 reduction of the damped step (g2o's LM rho
    # denominator): dx^T (lam D dx + b)
    return x, torch.sum(x * (lam * diag * x + b))


def _retract_all(g: PoseGraphData, dx_n: torch.Tensor) -> PoseGraphData:
    """Retract the free nodes; check_families leaves no live plane."""
    fn, _ = _free_masks(g)
    poses = torch.where(fn > 0, se3.pose_retract(g.poses, dx_n), g.poses)
    return g._replace(poses=poses)


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


def _chain_K(n: int) -> int:
    """Segment length of the chain backend: the largest power of two up
    to 64 that divides the node capacity (capacities are powers of two)."""
    k = 64
    while k > 2 and n % k:
        k //= 2
    return k


def optimize(g: PoseGraphData, cfg: OptimizerConfig,
             aux=None) -> OptimizeResult:
    """Levenberg-Marquardt with chi2-based accept/reject and Nielsen's
    lambda schedule, at most `g2o_solver_num_iterations` iterations;
    `gn_*` solver types run with a fixed tiny damping.

    The chain backend needs the coupling classification `aux`
    (chain_solver.classify); without one it is read off the graph. A
    chain step whose factorization fails raises RuntimeError."""
    from . import chain_solver
    backend = resolve_backend(cfg.solver_backend, g.n_nodes, g.n_planes,
                              cfg.auto_dense_max_dofs)
    check_families(g)
    is_lm = cfg.g2o_solver_type.startswith("lm")
    n = g.n_nodes
    dev = g.poses.device
    if backend == "chain":
        K = _chain_K(n)
        aux = chain_solver.aux_to(aux if aux is not None
                                  else chain_aux_for(g), dev)
    # one linearization per iteration: an accepted step hands its trial
    # linearization on, a rejected one keeps the current
    lin = linearize(g)
    chi2_0 = chi2 = lin.chi2
    lam = torch.full((), cfg.lm_initial_lambda if is_lm else 1e-9,
                     device=dev)
    nu = torch.full_like(lam, 2.0)
    g0norm = torch.full_like(lam, -1.0)
    cg_iters = torch.zeros((), dtype=torch.int64, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < cfg.g2o_solver_num_iterations:
        if backend == "dense":
            H, b, free = assemble_dense(g, lin)
            x, pred = dense_delta(H, b, free, lam)
            dx = x[:6 * n].view(n, 6)
        elif backend == "chain":
            dx, pred, ok = chain_solver.chain_delta(g, lin, lam, aux, K)
            failed = ~ok
        else:
            dx, pred, gnorm, k = cg_delta(g, lin, lam, g0norm,
                                          cfg.cg_max_iterations, cfg.cg_tol)
            g0norm = torch.where(g0norm < 0, gnorm, g0norm)
            cg_iters = cg_iters + k
        g_new = _retract_all(g, dx)
        lin_new = linearize(g_new)
        chi2_new = lin_new.chi2
        accept = chi2_new <= chi2
        if is_lm:
            rho = (chi2 - chi2_new) / torch.clamp(pred, min=1e-30)
            shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            lam_next = torch.where(accept, torch.clamp(lam * shrink,
                                                       min=1e-12),
                                   torch.clamp(lam * nu, max=1e10))
            nu = torch.where(accept, torch.full_like(nu, 2.0),
                             torch.clamp(nu * 2.0, max=1e8))
        else:
            lam_next = lam
        g = g._replace(poses=torch.where(accept, g_new.poses, g.poses))
        lin = LinearizedGraph(*(torch.where(accept, a, c)
                                for a, c in zip(lin_new, lin)))
        rel_improve = (chi2 - chi2_new) / torch.clamp(chi2, min=1e-12)
        done = ((accept & (rel_improve < cfg.chi2_rel_tol))
                | (lam_next > 1e8))
        chi2 = torch.where(accept, chi2_new, chi2)
        lam = lam_next
        it += 1
        # the one host read of the iteration
        stop, bad = torch.stack([done, failed]).tolist()
        if bad:
            raise RuntimeError(
                "chain solve: a segment or separator factorization failed "
                f"in LM iteration {it}")
        if stop:
            break
    return OptimizeResult(poses=g.poses, planes=g.planes,
                          chi2_initial=chi2_0, chi2_final=chi2,
                          iterations=it, lambda_final=lam,
                          cg_iterations=cg_iters)


def _inv_sym(blocks: torch.Tensor, ridge: float) -> torch.Tensor:
    eye = torch.eye(blocks.shape[-1], dtype=blocks.dtype,
                    device=blocks.device)
    return torch.linalg.solve_ex(blocks + ridge * eye,
                                 eye.expand(blocks.shape)).result


def marginals(g: PoseGraphData, exact: bool = True) -> torch.Tensor:
    """Per-node 6x6 covariance blocks, the diagonal of H^-1: (N, 6, 6).

    exact=True inverts the dense Hessian through its Cholesky factor (g2o's
    sparse marginals, graph_slam.cpp:401-425, at dense cost);
    exact=False inverts the diagonal blocks (block-Jacobi). Fixed and
    invalid nodes get zero covariance."""
    check_families(g)
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
        cov = _inv_sym(block_diagonal(g, lin), 1e-6)
    return cov * fn[:, :, None]


def marginals_selected(g: PoseGraphData, node_idx: torch.Tensor,
                       cg_max: Optional[int] = None, cg_tol: float = 1e-9
                       ) -> torch.Tensor:
    """Exact 6x6 covariance blocks of the selected nodes, matrix-free:
    H x = e for the 6 basis vectors of each selected node, solved by
    block-Jacobi PCG as 6m systems side by side (each stops on its own
    residual), then cov[a, b] = e_a^T H^-1 e_b. g2o's sparse selected
    marginals (graph_slam.cpp:401-425) without forming H.

    The system is H + 1e-6 I on the free dofs (the chain marginals' too;
    the dense path's ridge is 1e-9). CG runs at most `cg_max` iterations,
    by default 6 N (the size of the system, where CG ends in exact
    arithmetic) and no fewer than the JAX package's fixed 400, which
    leave full SLAM's 152-keyframe graph unconverged (ROADMAP.md §3 B6).

    node_idx: (m,) node ids -> (m, 6, 6); fixed and invalid nodes get
    zero covariance, as in `marginals`."""
    check_families(g)
    lin = linearize(g)
    fn, _ = _free_masks(g)
    D = block_diagonal(g, lin)
    hvp = make_hvp(g, lin)
    n, m = g.n_nodes, node_idx.shape[0]
    idx = node_idx.long()
    cols = torch.arange(6 * m, device=D.device)
    rhs = g.poses.new_zeros((n, 6, 6 * m))
    rhs[idx.repeat_interleave(6), cols % 6, cols] = 1.0
    # lam = 0; the 1e-6 ridge keeps unconstrained dofs bounded
    X, _ = pcg_solve(lambda v: hvp(v) + 1e-6 * v,
                     _block_jacobi(D, 0.0, torch.zeros_like(D[..., 0]), fn),
                     rhs * fn[:, :, None],
                     cg_max if cg_max is not None else max(400, 6 * n),
                     cg_tol)
    cov = X[idx].view(m, 6, m, 6).diagonal(dim1=0, dim2=2).permute(2, 1, 0)
    return cov * fn[idx][:, :, None]


def resolve_marginals_mode(mode: str, n_nodes: int, n_planes: int = 0
                           ) -> str:
    """"auto" -> exact dense H^-1 up to 4096 dofs, the batched-CG selected
    inverse beyond, so large graphs never pay O(D^3)."""
    if mode == "auto":
        return "exact" if 6 * n_nodes + 3 * n_planes <= 4096 else "cg"
    return mode
