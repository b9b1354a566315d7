"""Large-graph linear solver: segmented block-tridiagonal Cholesky + Woodbury.

Counterpart of the JAX package's graph/chain_solver.py, on one device. The
reference solves 10k-node graphs through g2o's sparse cholmod LM
(graph_slam.cpp:28-30,353); a dense (6N)^2 Hessian stops at 1-2k nodes and
block-Jacobi PCG stalls on long graph diameters. This is the exact solver
between them, built on how a SLAM Hessian is laid out:

  H + damping = T + U U^T

- T, block-tridiagonal: the odometry-chain SE3 edges (|from - to| = 1
  under the builder's insertion-ordered node ids), the unary priors, the
  plane block-diagonal (plane priors) and the LM damping.
  Nodes are cut into S segments of K; each segment's dense (6(K-1))^2
  interior is Cholesky-factored in one batched call, the interiors are
  eliminated onto the S separator nodes (each segment's last), and the
  6S x 6S reduced system is factored densely.
- U U^T: every other edge (loop closures, inter-robot edges, SE3-plane
  couplings, plane-plane constraints) enters as an exact low-rank
  correction, 6 columns per coupling edge (U = J^T W^1/2 rows at its two
  ends, a plane family's zero-padded to width 6), solved by the Woodbury
  identity
      x = y - Y_U (I + U^T Y_U)^-1 U^T y,   y = T^-1 b,  Y_U = T^-1 U.
  The number of coupling slots is a bucket chosen on the host (`_bucket`).

Numerics as in the JAX package: float32 with symmetric Jacobi
equilibration, `_sym_sqrt` a ridged Cholesky (not an eigendecomposition,
so U is the JAX package's), and one matrix-free iterative-refinement pass
against the damped Hessian. Y_U and the LU factors of I + U^T Y_U are
formed once a step and serve both the solve and the refinement pass (the
JAX package solves T for [b, U] twice; the columns are the same).

Vectors come in pairs (node stack (N, 6, k), plane stack (P, 3, k)). A
factorization that fails is reported through the `ok` flags, and the
callers raise: no solve quietly becomes another.

Distributed (a torch.distributed `group` of n_shards ranks, the graph
whole on every rank; parallel/dist_solver.py): each rank factors its
S / n_shards segments' interior panels, and the per-segment Schur
contributions and back-substituted interiors, zero outside a rank's
segments, are summed over the ranks (each rank owns a disjoint slice,
so the sum is the concatenation: the JAX package's `_scatter_psum`);
the reduced separator system is solved on every rank.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import solve as S


class ChainAux(NamedTuple):
    """Coupling slots classified on the host (-1: a padding slot). Shapes
    are the Woodbury buckets; values index the edge tables."""

    se3_cidx: np.ndarray  # (m1,) int32 non-chain SE3 edges
    pl_cidx: np.ndarray   # (m2,) int32 SE3-plane edges
    qq_cidx: np.ndarray   # (m3,) int32 plane-plane edges


def _bucket(n: int, lo: int = 8) -> int:
    """Woodbury slot count: `lo` up to lo, 16 up to 16, then the next
    multiple of 16 (a T-solve costs 6 columns a slot, so powers of two
    paid up to twice the columns)."""
    if n <= lo:
        return lo
    if n <= 16:
        return 16
    return ((n + 15) // 16) * 16


def classify(from_idx: np.ndarray, to_idx: np.ndarray, mask: np.ndarray,
             n_plane_edges: int, n_plane_plane: int,
             pl_mask: Optional[np.ndarray] = None,
             qq_mask: Optional[np.ndarray] = None) -> ChainAux:
    """Coupling classification from numpy staging buffers.

    A live SE3 edge is on the chain iff |from - to| == 1, which odometry
    edges are under the builder's insertion-ordered ids (per-robot runs
    of a merged graph too; an edge across another robot's id block just
    becomes a coupling column). Everything else couples."""
    from_idx = np.asarray(from_idx).astype(np.int64)
    to_idx = np.asarray(to_idx).astype(np.int64)
    live = np.flatnonzero(np.asarray(mask) & (np.abs(from_idx - to_idx) != 1))
    m1 = _bucket(len(live))
    se3_c = np.full(m1, -1, np.int32)
    se3_c[: len(live)] = live
    pl_live = (np.flatnonzero(pl_mask) if pl_mask is not None
               else np.arange(n_plane_edges))
    m2 = _bucket(len(pl_live), lo=1) if len(pl_live) else 1
    pl_c = np.full(m2, -1, np.int32)
    pl_c[: len(pl_live)] = pl_live
    qq_live = (np.flatnonzero(qq_mask) if qq_mask is not None
               else np.arange(n_plane_plane))
    m3 = _bucket(len(qq_live), lo=1) if len(qq_live) else 1
    qq_c = np.full(m3, -1, np.int32)
    qq_c[: len(qq_live)] = qq_live
    return ChainAux(se3_cidx=se3_c, pl_cidx=pl_c, qq_cidx=qq_c)


def aux_to(aux: ChainAux, device: torch.device) -> ChainAux:
    """The slots as int64 tensors on the device (one copy a solve)."""
    return ChainAux(*(torch.as_tensor(a, dtype=torch.int64, device=device)
                      for a in aux))


def _sym_sqrt(W: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched G with G G^T = W + ridge, by Cholesky -> (G, ok). Any
    factor of the edge's information serves Woodbury; the ridge (1e-12 +
    1e-7 tr/d) keeps rank-deficient and zero-masked W factorable, and its
    ~1e-7 relative error is taken out by chain_delta's refinement pass."""
    d = W.shape[-1]
    tr = torch.diagonal(W, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(d, dtype=W.dtype, device=W.device)
    G, info = torch.linalg.cholesky_ex(W + (1e-12 + 1e-7 * tr / d) * eye)
    return G, (info == 0).all()


class ChainFactors(NamedTuple):
    """With a group, the other ranks' segments hold an identity cholA and
    zero E and F."""

    cholA: torch.Tensor  # (S, mi, mi) per-segment interior Cholesky
    E: torch.Tensor      # (S, mi, 12) interior -> [left, right] separators
    F: torch.Tensor      # (S, mi, 12) A^-1 E
    cholR: torch.Tensor  # (6S, 6S) reduced separator Cholesky
    Tp_inv: torch.Tensor  # (P, 3, 3) inverses of the plane blocks
    ok: torch.Tensor     # () every factorization succeeded


def _damped(T: torch.Tensor, lam, d: torch.Tensor,
            free: torch.Tensor) -> torch.Tensor:
    """Diagonal blocks (K, k, k) damped by lam diag(H) + 1e-6 (as
    dense_delta) and projected: fixed and invalid members get I."""
    eye = torch.eye(T.shape[-1], dtype=T.dtype, device=T.device)
    return (T * (free[:, :, None] * free[:, None, :])
            + eye * (1.0 - free[:, 0, None, None])
            + torch.diag_embed((lam * d + 1e-6) * free[:, 0:1]))


def _chain_T(g, lin, lam, d, free):
    """Block-tridiagonal T and the plane block-diagonal, damped and
    projected -> (Td (N, 6, 6), Toff (N, 6, 6) with Toff[i] = T[i, i+1]
    and Toff[N-1] = 0, Tp (P, 3, 3)). `d` and `free` are per pool."""
    n, p = g.n_nodes, g.n_planes
    Td = lin.W_se3.new_zeros((n, 6, 6))
    Toff = lin.W_se3.new_zeros((n, 6, 6))
    if lin.r_se3.shape[0]:
        f, t = g.se3.from_idx.long(), g.se3.to_idx.long()
        chain = g.se3.mask & ((f - t).abs() == 1)
        Wc = lin.W_se3 * chain[:, None, None]
        WJi, WJj = Wc @ lin.Ji, Wc @ lin.Jj
        JiT, JjT = lin.Ji.transpose(1, 2), lin.Jj.transpose(1, 2)
        Td = S._segment_sum(JiT @ WJi, f, n) + S._segment_sum(JjT @ WJj, t, n)
        # the off-diagonal block H[lo, hi] = J_lo^T W J_hi, at slot lo
        Hlh = torch.where((f < t)[:, None, None], JiT @ WJj, JjT @ WJi)
        Toff = S._segment_sum(Hlh, torch.minimum(f, t), n)
    if lin.r_pr is not None:
        Td = Td + S._segment_sum(lin.Jp.transpose(1, 2) @ lin.W_pr @ lin.Jp,
                                 g.priors.node_idx.long(), n)
    Td = _damped(Td, lam, d[0], free[0])
    both_free = free[0][:-1, 0] * free[0][1:, 0]
    Toff = torch.cat([Toff[:-1] * both_free[:, None, None],
                      torch.zeros_like(Toff[-1:])])
    Tp = Td.new_zeros((p, 3, 3))
    if p:
        if lin.r_pp is not None:
            Tp = S._segment_sum(lin.Jpp.transpose(1, 2) @ lin.W_pp @ lin.Jpp,
                                g.plane_priors.plane_idx.long(), p)
        Tp = _damped(Tp, lam, d[1], free[1])
    return Td, Toff, Tp


def _my_segments(Sg: int, group, n_shards: int) -> Tuple[int, int]:
    """(first segment, segment count) of this rank's panels."""
    if Sg % n_shards:
        raise ValueError(f"{Sg} segments do not split over {n_shards} "
                         "ranks")
    loc = Sg // n_shards
    return (0 if group is None else group.rank() * loc), loc


def _own(Sg: int, group, n_shards: int, like: torch.Tensor) -> torch.Tensor:
    """(Sg, 1, 1): 1 on this rank's segments, 0 on the others'."""
    seg0, Sl = _my_segments(Sg, group, n_shards)
    own = like.new_zeros((Sg, 1, 1))
    own[seg0: seg0 + Sl] = 1.0
    return own


def _factor_T(Td: torch.Tensor, Toff: torch.Tensor, Tp: torch.Tensor,
              K: int, group=None, n_shards: int = 1) -> ChainFactors:
    """Two-level factorization of block-tridiagonal T: segments of K
    nodes, interiors their first K-1 nodes, separators their last;
    batched interior Cholesky, Schur complement onto the separators,
    dense reduced Cholesky. The plane blocks are inverted.

    With a group each rank Cholesky-factors its own segments' panels;
    the batched solves and products then run over all segments, the
    others' an identity factor and zero couplings, and the Schur
    contributions (with the count of failed panels) are summed over the
    ranks in one reduction. A segment's arithmetic is so the one
    device's: the card's batched solves round a panel by the batch's
    size, and 4 panels a rank of 32 solved otherwise than one device (the
    dry run's 2048-node chain then ended 1.44 m from one device over 8
    ranks on an H100, past its 1.0 m bound)."""
    n = Td.shape[0]
    if n % K:
        raise ValueError(f"node capacity {n} is not a multiple of K={K}")
    Sg, mi = n // K, 6 * (K - 1)
    seg0, Sl = _my_segments(Sg, group, n_shards)
    dev = Td.device
    Td_loc = Td[seg0 * K: (seg0 + Sl) * K]
    Toff_loc = Toff[seg0 * K: (seg0 + Sl) * K]
    A = Td.new_zeros((Sl, K - 1, K - 1, 6, 6))
    ii = torch.arange(K - 1, device=dev)
    A[:, ii, ii] = Td_loc.view(Sl, K, 6, 6)[:, : K - 1]
    if K > 2:
        jj = torch.arange(K - 2, device=dev)
        Oseg = Toff_loc.view(Sl, K, 6, 6)[:, : K - 2]
        A[:, jj, jj + 1] = Oseg
        A[:, jj + 1, jj] = Oseg.transpose(-1, -2)
    A = A.permute(0, 1, 3, 2, 4).reshape(Sl, mi, mi)
    cholA, info_a = torch.linalg.cholesky_ex(A)
    if group is not None:  # the other ranks' panels: identity factors
        eye = torch.eye(mi, dtype=A.dtype, device=dev)
        cholA = torch.cat([eye.expand(seg0, mi, mi), cholA,
                           eye.expand(Sg - seg0 - Sl, mi, mi)])

    # interior -> separator couplings E (S, mi, 12): columns 0:6 the left
    # separator (segment s-1's last node, by Toff[sK-1]^T at interior row
    # 0), columns 6:12 the right one (own last node, Toff[sK+K-2] at row
    # K-2)
    segs = torch.arange(Sg, device=dev)
    left = Toff[torch.clamp(segs * K - 1, min=0)] * (segs > 0)[:, None, None]
    right = Toff.view(Sg, K, 6, 6)[:, K - 2]
    E = Td.new_zeros((Sg, K - 1, 6, 12))
    E[:, 0, :, 0:6] = left.transpose(-1, -2)
    E[:, K - 2, :, 6:12] = right
    E = E.view(Sg, mi, 12)
    if group is not None:
        E = E * _own(Sg, group, n_shards, E)
    F = torch.cholesky_solve(E, cholA)

    # the reduced separator system, block-tridiagonal, assembled dense
    G = E.transpose(1, 2) @ F                        # (S, 12, 12)
    bad_a = (info_a != 0).sum().to(G.dtype)
    if group is not None:
        G, bad_a = S._sum_over(group, G, bad_a)
    Rd = Td.view(Sg, K, 6, 6)[:, K - 1] - G[:, 6:12, 6:12]
    Rd = Rd - torch.cat([G[1:, 0:6, 0:6], torch.zeros_like(G[:1, :6, :6])])
    Ro = -G[1:, 0:6, 6:12]                           # R[s-1, s], s >= 1
    R = Td.new_zeros((Sg, Sg, 6, 6))
    R[segs, segs] = Rd
    R[segs[:-1], segs[:-1] + 1] = Ro
    R[segs[:-1] + 1, segs[:-1]] = Ro.transpose(-1, -2)
    cholR, info_r = torch.linalg.cholesky_ex(
        R.permute(0, 2, 1, 3).reshape(6 * Sg, 6 * Sg))
    ok = (bad_a == 0) & (info_r == 0)
    Tp_inv = S._inv_sym(Tp, 0.0) if Tp.shape[0] else Tp
    return ChainFactors(cholA=cholA, E=E, F=F, cholR=cholR, Tp_inv=Tp_inv,
                        ok=ok)


def _solve_T(fac: ChainFactors, b: torch.Tensor, K: int,
             b_p: torch.Tensor, group=None, n_shards: int = 1):
    """T^-1 applied to stacked right-hand sides b (N, 6, k) and b_p
    (P, 3, k) -> (x (N, 6, k), x_p (P, 3, k)). With a group the interior
    substitutions are this rank's segments' (zero on the others'), and
    the separators' right-hand side and the interiors are summed over
    the ranks (two reductions an application)."""
    n, _, k = b.shape
    Sg, mi = n // K, 6 * (K - 1)
    bv = b.reshape(Sg, K, 6, k)
    b_int = bv[:, : K - 1].reshape(Sg, mi, k)
    if group is not None:
        b_int = b_int * _own(Sg, group, n_shards, b_int)
    y = torch.cholesky_solve(b_int, fac.cholA)
    r_red = S._sum_over(group, fac.E.transpose(1, 2) @ y)  # (S, 12, k)
    r_sep = bv[:, K - 1] - r_red[:, 6:12]
    r_sep = r_sep - torch.cat([r_red[1:, 0:6],
                               torch.zeros_like(r_red[:1, 0:6])])
    x_sep = torch.cholesky_solve(r_sep.reshape(6 * Sg, k),
                                 fac.cholR).view(Sg, 6, k)
    # each segment's [left, right] separator values
    x_lr = torch.cat([torch.cat([torch.zeros_like(x_sep[:1]), x_sep[:-1]]),
                      x_sep], dim=1)                 # (S, 12, k)
    x_int = S._sum_over(group, y - fac.F @ x_lr).view(Sg, K - 1, 6, k)
    x = torch.cat([x_int, x_sep[:, None]], dim=1).reshape(n, 6, k)
    return x, (fac.Tp_inv @ b_p if b_p.shape[0] else b_p)


# one coupling family's columns: (pool_a, idx_a, U_a (m, d_a, 6), pool_b,
# idx_b, U_b), pool 0 the nodes (d = 6), pool 1 the planes (d = 3)
Parts = List[Tuple[int, torch.Tensor, torch.Tensor, int, torch.Tensor,
                   torch.Tensor]]


def _coupling_U(g, lin, aux: ChainAux, free, sc) -> Tuple[Parts,
                                                          torch.Tensor]:
    """The Woodbury columns, kept factored by edge end and scaled like b
    (`free`, `sc` per pool): coupling edge c gives a 6-wide column block
    with rows U_a[c] = J_a^T W^1/2 at one end and U_b[c] at the other; a
    plane family's W^1/2 (3 or 4 rows) is zero-padded to 6 columns. A
    padding slot (-1) factors the ridge of a zero W, as in the JAX
    package. -> (parts, ok)."""
    parts: Parts = []
    ok = torch.ones((), dtype=torch.bool, device=g.poses.device)
    fams = []
    if lin.r_se3.shape[0] and aux.se3_cidx.shape[0]:
        t = g.se3
        fams.append((aux.se3_cidx, t.mask, lin.W_se3,
                     (0, t.from_idx, lin.Ji), (0, t.to_idx, lin.Jj)))
    if lin.r_pl is not None and aux.pl_cidx.shape[0]:
        t = g.plane_edges
        fams.append((aux.pl_cidx, t.mask, lin.W_pl,
                     (0, t.node_idx, lin.Jpl_pose),
                     (1, t.plane_idx, lin.Jpl_plane)))
    if lin.r_qq is not None and aux.qq_cidx.shape[0]:
        t = g.plane_plane
        fams.append((aux.qq_cidx, t.mask, lin.W_qq,
                     (1, t.from_idx, lin.Jqq_a), (1, t.to_idx, lin.Jqq_b)))
    for cidx, mask, W, (pa, ia, Ja), (pb, ib, Jb) in fams:
        e = torch.clamp(cidx, min=0)
        valid = (cidx >= 0) & mask[e]
        Wh, ok_w = _sym_sqrt(W[e] * valid[:, None, None])
        ok = ok & ok_w
        if Wh.shape[-1] < 6:
            Wh = torch.nn.functional.pad(Wh, (0, 6 - Wh.shape[-1]))
        ia, ib = ia[e].long(), ib[e].long()
        Ua = (Ja[e].transpose(1, 2) @ Wh
              * (free[pa][ia] * sc[pa][ia])[..., None])
        Ub = (Jb[e].transpose(1, 2) @ Wh
              * (free[pb][ib] * sc[pb][ib])[..., None])
        parts.append((pa, ia, Ua, pb, ib, Ub))
    return parts, ok


def _U_dense(parts: Parts, sizes, mtot: int, like: torch.Tensor):
    """U as right-hand sides: [(N, 6, 6m) node rows, (P, 3, 6m) plane
    rows]."""
    U = [like.new_zeros((k, d, 6 * mtot)) for k, d in zip(sizes, (6, 3))]
    off = 0
    for pa, ia, Ua, pb, ib, Ub in parts:
        m = Ua.shape[0]
        cols = (off * 6 + torch.arange(6 * m, device=like.device)
                ).view(m, 1, 6)
        for pool, i, Ui in ((pa, ia, Ua), (pb, ib, Ub)):
            rows = torch.arange(Ui.shape[1], device=like.device)[None, :,
                                                                 None]
            U[pool].index_put_((i[:, None, None], rows, cols), Ui,
                               accumulate=True)
        off += m
    return U


def _Ut_dot(parts: Parts, Y) -> torch.Tensor:
    """U^T Y from U's two-ends sparsity; Y = (node stack (N, 6, k), plane
    stack (P, 3, k)) -> (6m, k)."""
    outs = []
    for pa, ia, Ua, pb, ib, Ub in parts:
        o = Ua.transpose(1, 2) @ Y[pa][ia] + Ub.transpose(1, 2) @ Y[pb][ib]
        outs.append(o.reshape(-1, o.shape[-1]))
    return torch.cat(outs, dim=0)


def _scales(d, free, lam):
    """Symmetric Jacobi equilibration in the damped metric (dense_delta's
    rescale: float32 Cholesky of a raw SLAM Hessian stalls LM)."""
    sc = torch.rsqrt(torch.clamp((1 + lam) * d + 1e-6, min=1e-12)) * free
    return torch.where(free > 0, sc, torch.ones_like(sc))


def _scaled_T(g, lin, lam, d, free, sc, K, group=None,
              n_shards: int = 1) -> ChainFactors:
    Td, Toff, Tp = _chain_T(g, lin, lam, d, free)
    Td = Td * sc[0][:, :, None] * sc[0][:, None, :]
    Toff = Toff * sc[0][:, :, None] * torch.roll(sc[0], -1, 0)[:, None, :]
    Tp = Tp * sc[1][:, :, None] * sc[1][:, None, :]
    return _factor_T(Td, Toff, Tp, K, group, n_shards)


def _pool_terms(g, lin, lam):
    """Per pool: the free masks, the diagonals of H and the scales."""
    free = S._free_masks(g)
    d = [torch.diagonal(x, dim1=-2, dim2=-1)
         for x in S.block_diagonal(g, lin)]
    return free, d, [_scales(di, fi, lam) for di, fi in zip(d, free)]


def chain_delta(g, lin, lam, aux: ChainAux, K: int, group=None,
                n_shards: int = 1):
    """Exact damped Newton step by T + U U^T Woodbury: dense_delta's
    counterpart in the LM -> (dx_n (N, 6), dx_p (P, 3), predicted chi2
    reduction, ok). With a group of n_shards ranks (the graph whole on
    each) the segment panels of the factorization and of every T-solve
    are split over the ranks; the O(E) terms are computed on every rank."""
    sizes = (g.n_nodes, g.n_planes)
    free, d, sc = _pool_terms(g, lin, lam)
    g_n, g_p = S.gradient(g, lin)
    fac = _scaled_T(g, lin, lam, d, free, sc, K, group, n_shards)
    parts, ok = _coupling_U(g, lin, aux, free, sc)
    ok = ok & fac.ok
    mtot = sum(p[2].shape[0] for p in parts)

    # T holds a plane's priors and damping only, so a plane that only
    # plane-plane edges hold has T^-1 ~ 1/lam, and I + U^T T^-1 U spans
    # ~1e7 at small lam: past a float32 LU. With a plane pool that system
    # is factored in float64 (it is 6m x 6m, small beside the T-solves).
    s_dtype = torch.float64 if g.n_planes else sc[0].dtype
    if mtot:
        U_n, U_p = _U_dense(parts, sizes, mtot, sc[0])
        Y_U = _solve_T(fac, U_n, K, U_p, group, n_shards)
        LU, piv, info = torch.linalg.lu_factor_ex(
            torch.eye(6 * mtot, dtype=s_dtype, device=sc[0].device)
            + _Ut_dot(parts, Y_U).to(s_dtype))
        ok = ok & (info == 0)

    def wsolve(r):
        """(T + U U^T)^-1 r in the scaled space, r = (r_n (N, 6, 1),
        r_p (P, 3, 1))."""
        y = _solve_T(fac, r[0], K, r[1], group, n_shards)
        if not mtot:
            return y
        z = torch.linalg.lu_solve(LU, piv, _Ut_dot(parts, y).to(s_dtype))
        z = z.to(y[0].dtype)
        return tuple(yi - Yi @ z for yi, Yi in zip(y, Y_U))

    b = [(-gi * si)[..., None] for gi, si in zip((g_n, g_p), sc)]
    x = wsolve(b)
    # one refinement pass against the full damped Hessian (matrix-free)
    # in the scaled space: H^ v = S H S v + damping, and a unit diagonal
    # on projected-out dofs
    hvp = S.make_hvp(g, lin)
    scv = [si[..., None] for si in sc]
    Hx = hvp(tuple(xi * si for xi, si in zip(x, scv)))
    Hx = [h * si + ((lam * di + 1e-6) * s * s)[..., None] * xi
          + (1.0 - (fi > 0).to(xi.dtype))[..., None] * xi
          for h, si, di, s, xi, fi in zip(Hx, scv, d, sc, x, free)]
    e = wsolve([bi - hi for bi, hi in zip(b, Hx)])
    dx = [(xi + ei)[..., 0] * si * (fi > 0)
          for xi, ei, si, fi in zip(x, e, sc, free)]
    pred = sum(torch.sum(dxi * (lam * di * dxi - gi))
               for dxi, di, gi in zip(dx, d, (g_n, g_p)))
    return dx[0], dx[1], pred, ok


def chain_marginals(g, aux: ChainAux, K: int) -> torch.Tensor:
    """Per-node 6x6 covariance blocks, the diagonal of H^-1, by the same
    factorization and Woodbury identity as the chain step (lam = 0):

      H^-1 = T^-1 - Y S^-1 Y^T,   Y = T^-1 U,  S = I + U^T Y,

    with T^-1's diagonal blocks read off the two-level factors (interior
    blocks A^-1 + F Sigma_lr F^T, separator blocks off R^-1) and the
    correction taken at the diagonal only. T's 1e-6 ridge makes weakly
    constrained dofs slightly more conservative than the dense path's
    1e-9. Returns (N, 6, 6), zero for fixed and invalid nodes; raises
    RuntimeError when a factorization fails (one host read)."""
    n = g.n_nodes
    dev = g.poses.device
    aux = aux_to(aux, dev)
    lin = S.LinearizedGraph(*(a if a is None else a.double()
                              for a in S.linearize(g)))
    lam = torch.zeros((), dtype=torch.float64, device=dev)
    free, d, scs = _pool_terms(g, lin, lam)
    free_n, sc = free[0], scs[0]
    fac = _scaled_T(g, lin, lam, d, free, scs, K)
    Sg, mi = n // K, 6 * (K - 1)

    # T^-1's diagonal blocks. Separators: blocks of the reduced inverse
    eye_r = torch.eye(6 * Sg, dtype=sc.dtype, device=dev)
    Rb = torch.cholesky_solve(eye_r, fac.cholR).view(
        Sg, 6, Sg, 6).permute(0, 2, 1, 3)            # (S, S, 6, 6)
    ss = torch.arange(Sg, device=dev)
    sep_cov = Rb[ss, ss]
    # each segment's [left, right] separator covariance (12, 12); segment
    # 0 has no left separator
    sm1 = torch.clamp(ss - 1, min=0)
    has_left = (ss > 0).to(sc.dtype)[:, None, None]
    ll, lr = Rb[sm1, sm1] * has_left, Rb[sm1, ss] * has_left
    Slr = torch.cat([torch.cat([ll, lr], dim=2),
                     torch.cat([lr.transpose(-1, -2), sep_cov], dim=2)],
                    dim=1)
    # interiors: A^-1's diagonal blocks plus the separators' feedback
    eye_a = torch.eye(mi, dtype=sc.dtype, device=dev).repeat(Sg, 1, 1)
    Ainv = torch.cholesky_solve(eye_a, fac.cholA).view(Sg, K - 1, 6, K - 1,
                                                       6)
    Aind = Ainv.diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2)
    Fseg = fac.F.view(Sg, K - 1, 6, 12)
    int_cov = Aind + Fseg @ Slr[:, None] @ Fseg.transpose(-1, -2)
    covT = torch.cat([int_cov, sep_cov[:, None]], dim=1).reshape(n, 6, 6)

    # the Woodbury correction at the diagonal
    parts, ok = _coupling_U(g, lin, aux, free, scs)
    ok = ok & fac.ok
    mtot = sum(p[2].shape[0] for p in parts)
    if mtot:
        U_n, U_p = _U_dense(parts, (n, g.n_planes), mtot, sc)
        Y, Y_p = _solve_T(fac, U_n, K, U_p)
        eye_m = torch.eye(6 * mtot, dtype=sc.dtype, device=dev)
        Smat = eye_m + _Ut_dot(parts, (Y, Y_p))
        cS, info = torch.linalg.cholesky_ex(0.5 * (Smat + Smat.T)
                                            + 1e-9 * eye_m)
        ok = ok & (info == 0)
        Z = torch.cholesky_solve(Y.reshape(n * 6, 6 * mtot).T, cS).T
        covT = covT - Y @ Z.reshape(n, 6, 6 * mtot).transpose(1, 2)
    if not bool(ok):
        raise RuntimeError("chain marginals: a factorization failed")
    cov = covT * sc[:, :, None] * sc[:, None, :]
    return (cov * (free_n > 0)[:, :, None]).to(g.poses.dtype)
