"""Plain PyTorch reference of the SLAM layers the window drives.

Written from the semantics the port documents (prefilter, radius
covariances, GICP Gauss-Newton, fitness, keyframe gate, the pose graph's
EdgeSE3 residual and Huber kernel), not from its code: no import of the
port, of the JAX package or of JAX. Poses are 4x4 matrices. Every
function takes the dtype it computes in: the reference runs in float64,
its control (`judge.precision`) in float32 with TF32 matmuls.

Distances are the matmul expansion |a|^2 + |b|^2 - 2 a.b, the plain
form of `torch.cdist`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

PAD_VALUE = 1.0e10  # what a filtered cloud's unused lanes hold (compared
# through the mask only)
CHUNK = 2048


def radius_sq(radius: float) -> float:
    """radius^2 as the configuration's float32 radius squares in float32."""
    r = np.float32(radius)
    return float(r * r)


def dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 3), (M, 3) -> (N, M) squared distances by the matmul
    expansion."""
    return ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
            - 2.0 * (a @ b.T))


# -- SE(3) on 4x4 matrices ----------------------------------------------------

def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o],
                       -1).reshape(v.shape[:-1] + (3, 3))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def mat(pose7, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """(..., 7) [t, q wxyz] -> (..., 4, 4)."""
    p = torch.as_tensor(np.asarray(pose7, np.float64), dtype=dtype,
                        device=device)
    T = torch.zeros(p.shape[:-1] + (4, 4), dtype=dtype, device=device)
    T[..., :3, :3] = quat_to_mat(p[..., 3:7])
    T[..., :3, 3] = p[..., :3]
    T[..., 3, 3] = 1.0
    return T


def inv(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = torch.zeros_like(T)
    out[..., :3, :3] = R.transpose(-1, -2)
    out[..., :3, 3] = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def _coeffs(th2: torch.Tensor):
    """sin(t)/t, (1-cos t)/t^2, (t - sin t)/t^3 with their Taylor forms."""
    small = th2 < 1e-8
    s = torch.where(small, torch.ones_like(th2), th2)
    t = torch.sqrt(s)
    a = torch.where(small, 1 - th2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(t)) / s)
    c = torch.where(small, 1.0 / 6 - th2 / 120, (t - torch.sin(t)) / (s * t))
    return a, b, c


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twists [rho, theta] -> (..., 4, 4): R = exp(theta),
    t = J_l(theta) rho."""
    rho, w = xi[..., :3], xi[..., 3:]
    a, b, c = _coeffs((w * w).sum(-1))
    W = skew(w)
    I3 = torch.eye(3, dtype=xi.dtype, device=xi.device)
    WW = W @ W
    R = I3 + a[..., None, None] * W + b[..., None, None] * WW
    V = I3 + b[..., None, None] * W + c[..., None, None] * WW
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> rotation vectors: theta = atan2(sin, cos) from the
    skew part and the trace."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    vn = torch.linalg.vector_norm(v, dim=-1)  # 2 sin(theta)
    th = torch.atan2(0.5 * vn, 0.5 * (tr - 1.0))
    small = vn < 1e-12
    scale = torch.where(small, 0.5 * torch.ones_like(vn),
                        th / torch.where(small, torch.ones_like(vn), vn))
    return v * scale[..., None]


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, theta], rho = J_l(theta)^-1 t."""
    w = so3_log(T[..., :3, :3])
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    s = torch.where(small, torch.ones_like(th2), th2)
    t = torch.sqrt(s)
    k = torch.where(small, 1.0 / 12 + th2 / 720,
                    (1 - t * torch.sin(t) / (2 * (1 - torch.cos(t)))) / s)
    W = skew(w)
    I3 = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = I3 - 0.5 * W + k[..., None, None] * (W @ W)
    return torch.cat([(Vinv @ T[..., :3, 3:4])[..., 0], w], -1)


def angle(R: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(so3_log(R), dim=-1)


def pose_gap(A: torch.Tensor, B: torch.Tensor, reach: float = 10.0
             ) -> torch.Tensor:
    """How far apart two poses put the world: |dt| + reach * |dtheta| (a
    point `reach` metres out moves by at most this)."""
    D = inv(A) @ B
    return (torch.linalg.vector_norm(A[..., :3, 3] - B[..., :3, 3], dim=-1)
            + reach * angle(D[..., :3, :3]))


# -- prefilter -----------------------------------------------------------------

def _scramble(key: torch.Tensor) -> torch.Tensor:
    """The voxel grid's pseudo-random order of a key, in int32 arithmetic
    (Knuth multiplicative hash, arithmetic shift, abs)."""
    h = key.to(torch.int64) * -1640531527
    h = ((h + 2 ** 31) % 2 ** 32) - 2 ** 31  # wrap to int32
    h = h ^ (h >> 15)
    return torch.abs(h) & (2 ** 30 - 1)


class Filtered(NamedTuple):
    points: torch.Tensor  # (cap, 3) in the reference dtype
    mask: torch.Tensor    # (cap,)


def prefilter(raw: torch.Tensor, rmask: torch.Tensor, pre: dict,
              dtype=torch.float64) -> Filtered:
    """Distance filter -> voxel-grid means -> RADIUS outlier removal of one
    float32 scan. The grid is the configuration's: float32 coordinates
    divided by the resolution, floored, wrapped to a 1024-cell window a
    side; at most `capacity_filtered_points` voxels are kept, the first
    in (scrambled key, key) order."""
    cap = pre["capacity_filtered_points"]
    d = torch.sqrt(torch.sum(raw * raw, dim=-1))
    keep = rmask & (d > pre.get("distance_near_thresh", 0.1)) \
        & (d < pre.get("distance_far_thresh", 35.0))
    c = torch.floor(raw / pre["downsample_resolution"]).to(torch.int64) \
        & 1023
    key = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    key = key[keep]
    pts = raw[keep].to(dtype)
    uniq, inv_idx = torch.unique(key, return_inverse=True)
    rank = torch.argsort(_scramble(uniq) * 2 ** 31 + uniq)
    take = rank[:cap]
    slot = torch.full_like(uniq, -1)
    slot[take] = torch.arange(len(take), device=raw.device)
    s = slot[inv_idx]
    use = s >= 0
    sums = torch.zeros((cap, 3), dtype=dtype, device=raw.device)
    cnt = torch.zeros(cap, dtype=dtype, device=raw.device)
    sums.index_add_(0, s[use], pts[use])
    cnt.index_add_(0, s[use], torch.ones_like(pts[use, 0]))
    mask = cnt >= pre.get("downsample_min_points_per_voxel", 1)
    means = sums / cnt.clamp(min=1)[:, None]
    means = torch.where(mask[:, None], means,
                        torch.full_like(means, PAD_VALUE))
    if pre.get("outlier_removal_method") == "RADIUS":
        r2 = radius_sq(pre["radius_radius"])
        n = torch.zeros(cap, dtype=torch.int64, device=raw.device)
        for a in range(0, cap, CHUNK):
            w = (dist2(means[a:a + CHUNK], means) <= r2) & mask[None, :]
            n[a:a + CHUNK] = w.sum(1) - 1  # others, not the point itself
        mask = mask & (n >= pre["radius_min_neighbors"])
    return Filtered(torch.where(mask[:, None], means,
                                torch.full_like(means, PAD_VALUE)), mask)


# -- GICP ----------------------------------------------------------------------

class Gicp(NamedTuple):
    points: torch.Tensor  # (P, 3)
    mask: torch.Tensor    # (P,)
    covs: torch.Tensor    # (P, 3, 3)


def covariances(f: Filtered, radius: float) -> Gicp:
    """Plane-regularized radius covariances: the neighbours within
    `radius` (self included) of each valid point; (eps, 1, 1) spectrum
    along the smallest eigenvector; I with fewer than 3 neighbours."""
    p, m = f.points, f.mask
    r2 = radius_sq(radius)
    x, y, z = p.unbind(-1)
    feats = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                         y * y, y * z, z * z], -1)
    feats = torch.where(m[:, None], feats, torch.zeros_like(feats))
    mo = torch.empty_like(feats)
    for a in range(0, len(p), CHUNK):
        w = (dist2(p[a:a + CHUNK], p) <= r2) & m[None, :]
        mo[a:a + CHUNK] = w.to(p.dtype) @ feats
    cnt = mo[:, 0].clamp(min=1)
    mean = mo[:, 1:4] / cnt[:, None]
    xx, xy, xz, yy, yz, zz = (mo[:, 4:] / cnt[:, None]).unbind(-1)
    m2 = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], -1).reshape(-1,
                                                                       3, 3)
    cov = m2 - mean[:, :, None] * mean[:, None, :]
    cov = torch.where(torch.isfinite(cov), cov, torch.zeros_like(cov))
    # eigh in batches: cuSOLVER's batched solver refuses 32768 at once
    n = torch.cat([torch.linalg.eigh(cov[a:a + CHUNK])[1][..., 0]
                   for a in range(0, len(cov), CHUNK)])
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    reg = eye - (1.0 - 1e-3) * n[:, :, None] * n[:, None, :]
    ok = m & (mo[:, 0] >= 3)
    return Gicp(p, m, torch.where(ok[:, None, None], reg, eye.expand_as(reg)))


def nearest(pw: torch.Tensor, tgt: torch.Tensor, tmask: torch.Tensor):
    """1-NN of each row of pw among the valid targets -> (d2, idx)."""
    d2s, idxs = [], []
    inf = torch.tensor(float("inf"), dtype=pw.dtype, device=pw.device)
    for a in range(0, len(pw), CHUNK):
        d2 = torch.where(tmask[None, :], dist2(pw[a:a + CHUNK], tgt), inf)
        v, i = d2.min(1)
        d2s.append(v)
        idxs.append(i)
    return torch.cat(d2s), torch.cat(idxs)


def _gn_step(src: Gicp, tgt: Gicp, T: torch.Tensor, max_corr: float):
    R, t = T[:3, :3], T[:3, 3]
    pw = src.points @ R.T + t
    d2, idx = nearest(pw, tgt.points, tgt.mask)
    valid = src.mask & (d2 <= radius_sq(max_corr))
    q, Cq = tgt.points[idx], tgt.covs[idx]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    W = torch.linalg.inv(Cq + R @ src.covs @ R.T + 1e-6 * eye)
    W = W * valid.to(T.dtype)[:, None, None]
    r = q - pw
    J = torch.cat([-R.expand(len(pw), 3, 3), R @ skew(src.points)], -1)
    WJ = W @ J
    H = torch.einsum("nai,naj->ij", J, WJ)
    b = torch.einsum("naj,na->j", WJ, r)
    err = torch.einsum("na,nab,nb->", r, W, r)
    n_in = int(valid.sum())
    xi = torch.linalg.solve(H + 1e-6 * torch.eye(6, dtype=T.dtype,
                                                 device=T.device), -b)
    return xi, float(err) / max(n_in, 1), n_in


def _stage(src, tgt, T, budget, eps, stall_eps, max_corr):
    err, stall, n_in, it, done = math.inf, 0, 0, 0, False
    while it < budget:
        xi, err2, n_in = _gn_step(src, tgt, T, max_corr)
        T = T @ exp(xi)
        it += 1
        done = (float(torch.linalg.vector_norm(xi[:3])) < eps
                and float(torch.linalg.vector_norm(xi[3:])) < eps)
        stop = done
        if stall_eps > 0:
            improve = ((err - err2) / max(err, 1e-12)
                       if math.isfinite(err) else math.inf)
            stall = stall + 1 if improve < stall_eps else 0
            done = done or (stall >= 2 and n_in > 0)
            stop = done or n_in == 0
        err = err2
        if stop:
            break
    return T, it, n_in, done


def _strided(c: Gicp, s: int) -> Gicp:
    return Gicp(c.points[::s], c.mask[::s], c.covs[::s])


def align(src: Gicp, tgt: Gicp, T0: torch.Tensor, reg: dict,
          max_iters: Optional[int] = None, eps: Optional[float] = None
          ) -> tuple:
    """GICP of src onto tgt from T0 with the registration settings `reg`:
    a coarse stage on every stride-th lane, then the full clouds, each
    with the update and stall exits. -> (T, iterations, inliers, whether
    the last stage met an exit before its budget ran out)."""
    iters = reg["reg_maximum_iterations"] if max_iters is None else max_iters
    eps = reg["reg_transformation_epsilon"] if eps is None else eps
    stall = reg.get("reg_stall_epsilon", 0.0)
    corr = reg["reg_max_correspondence_distance"]
    stride = int(reg.get("reg_coarse_stride", 1))
    T, n_c = T0, 0
    if stride > 1:
        budget_c = min(reg.get("reg_coarse_iterations", 0),
                       max(iters - 1, 0))
        T, n_c, _, _ = _stage(_strided(src, stride), _strided(tgt, stride),
                              T, budget_c, eps, stall, corr)
        iters = max(iters - budget_c, 0)
    T, n_f, n_in, done = _stage(src, tgt, T, iters, eps, stall, corr)
    return T, n_c + n_f, n_in, done


def fitness(src: Gicp, tgt: Gicp, T: torch.Tensor,
            max_range: float = math.inf) -> float:
    """Mean squared distance of the valid sources, moved by T, to their
    nearest valid target, over those within `max_range` (all by
    default); inf with none."""
    pw = src.points @ T[:3, :3].T + T[:3, 3]
    d2, _ = nearest(pw, tgt.points, tgt.mask)
    ok = src.mask & torch.isfinite(d2)
    if math.isfinite(max_range):
        ok = ok & (d2 <= radius_sq(max_range))
    n = int(ok.sum())
    return float(d2[ok].sum()) / n if n else math.inf


def information(fit: float, inf_cfg: dict) -> torch.Tensor:
    """The fitness-driven information matrix (variance interpolated
    between the min and max stddev by 1 - exp(-a x)); a fitness that is
    not finite saturates at the threshold."""
    c = inf_cfg
    x = fit if math.isfinite(fit) else c["fitness_score_thresh"]

    def var(lo, hi):
        y = ((1.0 - math.exp(-c["var_gain_a"] * x))
             / (1.0 - math.exp(-c["var_gain_a"] * c["fitness_score_thresh"])))
        return lo * lo + (hi * hi - lo * lo) * y

    d = [1.0 / var(c["min_stddev_x"], c["max_stddev_x"])] * 3 \
        + [1.0 / var(c["min_stddev_q"], c["max_stddev_q"])] * 3
    return torch.diag(torch.tensor(d, dtype=torch.float64))


# -- keyframes and the pose graph -------------------------------------------------

def keyframe_frames(poses: np.ndarray, delta_trans: float,
                    delta_angle: float) -> list:
    """Frames the keyframe gate admits: the first, then each whose pose
    moved more than delta_trans or turned more than delta_angle since
    the last admitted one."""
    out, prev = [], None
    for i, p in enumerate(np.asarray(poses, np.float64)):
        if prev is not None:
            dt = np.linalg.norm(p[:3] - prev[:3])
            da = 2.0 * np.arccos(min(1.0, abs(float(np.dot(p[3:7],
                                                          prev[3:7])))))
            if dt < delta_trans and da < delta_angle:
                continue
        out.append(i)
        prev = p
    return out


class Graph(NamedTuple):
    poses: torch.Tensor     # (N, 4, 4) initial estimates
    fixed: torch.Tensor     # (N,) bool
    frm: torch.Tensor       # (E,) node index
    to: torch.Tensor        # (E,)
    meas: torch.Tensor      # (E, 4, 4)
    info: torch.Tensor      # (E, 6, 6)
    huber: torch.Tensor     # (E,) kernel width, 0 for none


def residuals(g: Graph, poses: torch.Tensor) -> torch.Tensor:
    """EdgeSE3: log(meas^-1 T_from^-1 T_to) -> (E, 6)."""
    return log(inv(g.meas) @ inv(poses[g.frm]) @ poses[g.to])


def _robust_info(g: Graph, r: torch.Tensor) -> torch.Tensor:
    """Information scaled by the Huber kernel's rho'(r^T Omega r)."""
    e = torch.einsum("ea,eab,eb->e", r, g.info, r).clamp(min=0)
    w = torch.where((g.huber > 0) & (e > g.huber ** 2),
                    g.huber / torch.sqrt(e + 1e-20), torch.ones_like(e))
    return g.info * w[:, None, None]


def chi2(g: Graph, poses: torch.Tensor) -> float:
    r = residuals(g, poses)
    e = torch.einsum("ea,eab,eb->e", r, g.info, r).clamp(min=0)
    d2 = g.huber ** 2
    rho = torch.where((g.huber > 0) & (e > d2),
                      2 * g.huber * torch.sqrt(e + 1e-20) - d2, e)
    return float(rho.sum())


def _edge_jacobians(g: Graph, poses: torch.Tensor, h: float):
    """Central differences of each edge's residual in the right chart of
    its two ends -> (J_from, J_to), each (E, 6, 6)."""
    dt = poses.dtype
    steps = exp(h * torch.eye(6, dtype=dt, device=poses.device))  # (6,4,4)
    back = exp(-h * torch.eye(6, dtype=dt, device=poses.device))
    Mi = inv(g.meas)[:, None]
    Tf, Tt = poses[g.frm][:, None], poses[g.to][:, None]
    jf = (log(Mi @ inv(Tf @ steps) @ Tt) - log(Mi @ inv(Tf @ back) @ Tt))
    jt = (log(Mi @ inv(Tf) @ (Tt @ steps)) - log(Mi @ inv(Tf) @ (Tt @ back)))
    return (jf.transpose(1, 2) / (2 * h), jt.transpose(1, 2) / (2 * h))


def optimize(g: Graph, iterations: int = 100, h: float = 1e-6
             ) -> torch.Tensor:
    """Levenberg-Marquardt over the free nodes in the right chart
    (T <- T exp(dx)), Jacobians by central differences, the Huber kernel
    by reweighting. -> (N, 4, 4) optimized poses."""
    poses = g.poses.clone()
    dev, dt = poses.device, poses.dtype
    n, e = len(poses), len(g.frm)
    free = (~g.fixed).nonzero()[:, 0]
    col = torch.full((n,), -1, dtype=torch.int64, device=dev)
    col[free] = torch.arange(len(free), device=dev)
    m = 6 * len(free)
    lam, cur = 1e-6, chi2(g, poses)
    for _ in range(iterations):
        r = residuals(g, poses)
        jf, jt = _edge_jacobians(g, poses, h)
        J = torch.zeros((e, 6, m + 6), dtype=dt, device=dev)
        rows = torch.arange(e, device=dev)
        for jac, end in ((jf, g.frm), (jt, g.to)):
            c = col[end]
            c = torch.where(c >= 0, c, torch.full_like(c, len(free)))
            idx = (6 * c[:, None] + torch.arange(6, device=dev))  # (E, 6)
            J[rows[:, None, None], torch.arange(6, device=dev)[None, :, None],
              idx[:, None, :]] += jac
        J = J[:, :, :m]
        WJ = _robust_info(g, r) @ J
        H = J.reshape(6 * e, m).T @ WJ.reshape(6 * e, m)
        b = torch.einsum("eai,ea->i", WJ, r)
        while True:
            dx, bad = torch.linalg.solve_ex(
                H + lam * torch.diag(torch.diag(H)), -b)
            new = math.inf
            if not bool(bad) and bool(torch.isfinite(dx).all()):
                trial = poses.clone()
                trial[free] = poses[free] @ exp(dx.reshape(-1, 6))
                new = chi2(g, trial)
            if new <= cur or lam > 1e8:
                break
            lam *= 10
        if not new <= cur:
            break
        gain, poses, cur = cur - new, trial, new
        lam = max(lam / 10, 1e-12)
        if float(dx.abs().max()) < 1e-9 or gain <= 1e-15 * max(cur, 1.0):
            break
    return poses
