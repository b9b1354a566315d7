"""KITTI odometry sequences (numpy only, no pykitti and no ROS).

The port's own copy of the JAX package's io/kitti.py, which replaces the
pykitti use of python_scripts/kitti_*_processor.py: velodyne .bin scans,
times.txt, calib.txt and the ground-truth poses moved from the cam0
frame into the velodyne frame.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np


def load_velodyne_bin(path) -> np.ndarray:
    """KITTI velodyne scan: float32 x,y,z,reflectance -> (N,3)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return raw[:, :3]


def load_times(path) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64).reshape(-1)


def load_poses(path) -> np.ndarray:
    """poses.txt: 12 floats per line (3x4 row-major cam0 poses) -> (N,4,4)."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :] = rows
    return out


def load_calib_velo_to_cam(calib_path) -> np.ndarray:
    """Tr line of calib.txt: velodyne -> cam0 (4x4)."""
    for line in Path(calib_path).read_text().splitlines():
        if line.startswith("Tr"):
            vals = np.asarray(line.split(":", 1)[1].split(), np.float64)
            T = np.eye(4)
            T[:3, :] = vals.reshape(3, 4)
            return T
    raise ValueError(f"no Tr line in {calib_path}")


@dataclasses.dataclass
class KittiSequence:
    """One KITTI odometry sequence rooted at
    <root>/sequences/<seq>/ (+ <root>/poses/<seq>.txt if present)."""

    velodyne_files: List[Path]
    times: np.ndarray
    gt_poses_velo: Optional[np.ndarray]  # (N,4,4) in the velodyne frame

    @staticmethod
    def open(root: str, sequence: str) -> "KittiSequence":
        seq_dir = Path(root) / "sequences" / sequence
        velo = sorted((seq_dir / "velodyne").glob("*.bin"))
        times = load_times(seq_dir / "times.txt")
        gt = None
        pose_file = Path(root) / "poses" / f"{sequence}.txt"
        if pose_file.exists():
            cam_poses = load_poses(pose_file)
            Tr = load_calib_velo_to_cam(seq_dir / "calib.txt")
            # velodyne-frame trajectory: Tr^-1 * T_cam * Tr
            Tr_inv = np.linalg.inv(Tr)
            gt = np.einsum("ij,njk,kl->nil", Tr_inv, cam_poses, Tr)
        return KittiSequence(velodyne_files=velo, times=times,
                             gt_poses_velo=gt)

    def __len__(self) -> int:
        return len(self.velodyne_files)

    def scan(self, i: int) -> np.ndarray:
        return load_velodyne_bin(self.velodyne_files[i])
