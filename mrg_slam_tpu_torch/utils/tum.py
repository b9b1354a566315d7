"""TUM trajectory file IO: `stamp tx ty tz qx qy qz qw` per line.

The reference's evaluation currency (g2o_to_pose_file.py,
graph_database.cpp:599 save_keyframe_poses). A copy of the JAX package's
utils/tum.py (numpy only), so the port needs nothing of that package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def save_tum(path, stamps: Sequence[float], poses: np.ndarray) -> None:
    """poses: (N,7) [tx ty tz qw qx qy qz] (our order) -> TUM (qx qy qz qw)."""
    poses = np.asarray(poses)
    with open(path, "w") as f:
        for s, p in zip(stamps, poses):
            f.write(f"{s:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{p[4]:.6f} {p[5]:.6f} {p[6]:.6f} {p[3]:.6f}\n")


def load_tum(path) -> tuple[np.ndarray, np.ndarray]:
    """-> (stamps (N,), poses (N,7) in our [t, qw qx qy qz] order)."""
    data = np.loadtxt(path, ndmin=2)
    stamps = data[:, 0]
    t = data[:, 1:4]
    qxyzw = data[:, 4:8]
    poses = np.concatenate([t, qxyzw[:, 3:4], qxyzw[:, 0:3]], axis=1)
    return stamps, poses.astype(np.float32)
