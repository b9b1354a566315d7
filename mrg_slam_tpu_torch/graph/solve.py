"""Manifold Levenberg-Marquardt for the pose graph, dense backend.

Counterpart of the dense path of the JAX package's graph/solve.py (the
reference wraps g2o's sparse LM with cholmod, graph_slam.cpp:353-425):
6x6 blocks scatter into a (D, D) Hessian, D = 6 N + 3 P, which is
equilibrated, Cholesky-factored and refined once per step. Robust kernels
enter as IRLS weights at every linearization; fixed nodes (the anchor)
and padding lanes are projected out of the update.

The JAX package runs the LM iterations in one `lax.while_loop`; here they
are a Python loop whose only host read per iteration is the stop flag.
Scatters go through `index_put_(..., accumulate=True)`, which PyTorch
runs deterministically on the card under
`torch.use_deterministic_algorithms(True)` (runtime.py), so the same graph
gives the same poses bit for bit.

Only the SE3-SE3 family is ported: a graph whose prior, plane or
plane-plane table holds an edge, or which has a plane node, raises
NotImplementedError (ROADMAP.md queue 1 item 12); tables of zero capacity
or without a live edge are elided. The "cg" and "chain" backends and the
"cg" marginals wait for item 13.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import OptimizerConfig
from ..utils import se3
from .edges import se3_edge_terms
from .robust import robust_rho_and_weight
from .types import PoseGraphData

_LATER_SOLVERS = "waits for ROADMAP.md queue 1 item 13 (large-graph solvers)"


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
    """"auto" -> dense while 6N+3P <= max_dofs, chain beyond; "chain" and
    "cg" raise NotImplementedError (item 13)."""
    if backend == "auto":
        backend = "dense" if 6 * n_nodes + 3 * n_planes <= max_dofs \
            else "chain"
    if backend != "dense":
        raise NotImplementedError(
            f"solver backend {backend!r} is not ported yet: it "
            f"{_LATER_SOLVERS}")
    return backend


def optimize(g: PoseGraphData, cfg: OptimizerConfig) -> OptimizeResult:
    """Levenberg-Marquardt with chi2-based accept/reject and Nielsen's
    lambda schedule, at most `g2o_solver_num_iterations` iterations;
    `gn_*` solver types run with a fixed tiny damping."""
    resolve_backend(cfg.solver_backend, g.n_nodes, g.n_planes,
                    cfg.auto_dense_max_dofs)
    check_families(g)
    is_lm = cfg.g2o_solver_type.startswith("lm")
    n = g.n_nodes
    # one linearization per iteration: an accepted step hands its trial
    # linearization on, a rejected one keeps the current
    lin = linearize(g)
    chi2_0 = chi2 = lin.chi2
    lam = torch.full((), cfg.lm_initial_lambda if is_lm else 1e-9,
                     device=g.poses.device)
    nu = torch.full_like(lam, 2.0)
    it = 0
    while it < cfg.g2o_solver_num_iterations:
        H, b, free = assemble_dense(g, lin)
        x, pred = dense_delta(H, b, free, lam)
        g_new = _retract_all(g, x[:6 * n].view(n, 6))
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
        if bool(done):  # the one host read of the iteration
            break
    return OptimizeResult(poses=g.poses, planes=g.planes,
                          chi2_initial=chi2_0, chi2_final=chi2,
                          iterations=it, lambda_final=lam)


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


def resolve_marginals_mode(mode: str, n_nodes: int, n_planes: int = 0
                           ) -> str:
    """"auto" -> exact dense H^-1 up to 4096 dofs, "cg" beyond; "cg"
    raises NotImplementedError (item 13)."""
    if mode == "auto":
        mode = "exact" if 6 * n_nodes + 3 * n_planes <= 4096 else "cg"
    if mode == "cg":
        raise NotImplementedError(
            f"cg marginals are not ported yet: they {_LATER_SOLVERS}")
    return mode
