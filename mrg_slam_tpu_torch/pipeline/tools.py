"""Result tooling: g2o -> TUM conversion and evo-style evaluation reports.

Counterpart of the JAX package's pipeline/tools.py: the equivalents of
python_scripts/g2o_to_pose_file.py and generate_evo_results.sh (ATE and
RPE with Umeyama alignment, --align). Host numpy over files; nothing here
touches a device.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict

import numpy as np

from ..utils.metrics import rpe_rmse, umeyama_alignment
from ..utils.tum import load_tum, save_tum


def g2o_to_poses(g2o_path) -> np.ndarray:
    """Parse VERTEX_SE3:QUAT lines -> (N, 7) poses in our [t, wxyz] order,
    by vertex id, FIX'd vertices left out (as g2o_to_pose_file.py's
    accum_dist < 0 filter leaves out loaded and static ones)."""
    fixed_ids = set()
    rows = []
    for line in Path(g2o_path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "FIX":
            fixed_ids.add(int(parts[1]))
        elif parts[0] == "VERTEX_SE3:QUAT":
            vid = int(parts[1])
            tx, ty, tz, qx, qy, qz, qw = map(float, parts[2:9])
            rows.append((vid, [tx, ty, tz, qw, qx, qy, qz]))
    poses = [p for vid, p in sorted(rows) if vid not in fixed_ids]
    return np.asarray(poses, np.float32)


def g2o_to_tum(g2o_path, tum_path, dt: float = 0.1) -> int:
    """Write a .g2o file's free vertices as a TUM file, `dt` seconds
    apart; -> how many."""
    poses = g2o_to_poses(g2o_path)
    save_tum(tum_path, np.arange(len(poses)) * dt, poses)
    return len(poses)


@dataclasses.dataclass
class EvoResult:
    ate_rmse: float
    ate_mean: float
    ate_max: float
    rpe_rmse: float
    n_poses: int

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def evaluate_tum(est_path, gt_path, align: bool = True) -> EvoResult:
    """evo_ape + evo_rpe over two TUM files (nearest-stamp association,
    Umeyama --align)."""
    s_est, p_est = load_tum(est_path)
    s_gt, p_gt = load_tum(gt_path)
    idx = np.clip(np.searchsorted(s_gt, s_est), 0, len(s_gt) - 1)
    prev = np.clip(idx - 1, 0, len(s_gt) - 1)
    pick = np.where(np.abs(s_gt[prev] - s_est) < np.abs(s_gt[idx] - s_est),
                    prev, idx)
    gt = p_gt[pick][:, :3].astype(np.float64)
    est = p_est[:, :3].astype(np.float64)
    if align and len(est) >= 3:
        R, t, s = umeyama_alignment(est, gt)
        est = est @ (s * R).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return EvoResult(
        ate_rmse=float(np.sqrt((err ** 2).mean())),
        ate_mean=float(err.mean()), ate_max=float(err.max()),
        rpe_rmse=rpe_rmse(est, gt), n_poses=len(est))


def write_report(result: EvoResult, path) -> None:
    Path(path).write_text(json.dumps(result.to_dict(), indent=2))
