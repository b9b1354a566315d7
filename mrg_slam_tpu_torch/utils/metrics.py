"""Trajectory evaluation: ATE with Umeyama alignment, and RPE (numpy only).

The equivalent of the `evo_ape --align` and `evo_rpe` calls the reference
uses as its acceptance metric (generate_evo_results.sh:22-38); a copy of
the JAX package's utils/metrics.py, so the port needs nothing of that
package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray,
                      with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning x onto y.

    x, y: (N, 3). Returns (R, t, s) with y ~= s * R @ x + t.
    """
    mu_x = x.mean(0)
    mu_y = y.mean(0)
    xc, yc = x - mu_x, y - mu_y
    cov = yc.T @ xc / x.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc ** 2).sum() / x.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_x)
    else:
        s = 1.0
    t = mu_y - s * R @ mu_x
    return R, t, s


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE after (optional) Umeyama alignment."""
    est = np.asarray(est_xyz, dtype=np.float64)
    gt = np.asarray(gt_xyz, dtype=np.float64)
    if est.shape != gt.shape:
        raise ValueError(f"shapes differ: {est.shape} vs {gt.shape}")
    if align:
        R, t, s = umeyama_alignment(est, gt)
        est = est @ (s * R).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over frame pairs `delta` apart."""
    est = np.asarray(est_xyz, dtype=np.float64)
    gt = np.asarray(gt_xyz, dtype=np.float64)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(de, axis=1) - np.linalg.norm(dg, axis=1)
    return float(np.sqrt((err ** 2).mean()))
