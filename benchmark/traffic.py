"""The one generator of traffic: a mix file -> episodes of frame blocks.

A mix (`traffic/<name>.json`) is data: the path robots drive (`circle`
or `line`), the step between frames, the frames of an episode, how many
distinct episodes set-up makes (`pool_episodes`), the world's seed and,
for a fleet, each robot's window of the episode's frames. Each episode's
world, path and every scan's sampling and noise come from the run's
`--seed` and the episode's place in the pool: a seed makes its own data,
and every seed the same amount of it (the same frames, lanes and path
lengths).

An episode's frames are laid out as blocks for the window: block b holds,
for robot r and frame i < B, the scan of episode frame windows[r][0] +
b*B + i at row r*B + i.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import world as worldlib

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def yaw_pose(x: float, y: float, z: float, yaw: float) -> np.ndarray:
    return np.array([x, y, z, math.cos(yaw / 2), 0.0, 0.0,
                     math.sin(yaw / 2)], np.float64)


def _seed_words(seed: int) -> list:
    """A whole number of any size as numpy seed words."""
    seed = int(seed)
    return [seed % 2 ** 32, (seed // 2 ** 32) % 2 ** 32, int(seed < 0)]


def path_poses(mix: dict, seed: int, episode: int) -> np.ndarray:
    """(episode_frames, 7) ground-truth poses of pool episode `episode`:
    a circle from a start phase, or a line on a heading through a point
    near the centre, both drawn from (seed, episode)."""
    rng = np.random.default_rng(_seed_words(seed) + [episode])
    n, step, z = mix["episode_frames"], mix["step_m"], mix["z_m"]
    if mix["path"] == "circle":
        r = mix["radius_m"]
        phase = rng.uniform(0.0, 2.0 * math.pi)
        th = phase + np.arange(n) * step / r
        return np.stack([yaw_pose(r * math.cos(t), r * math.sin(t), z,
                                  t + math.pi / 2) for t in th])
    if mix["path"] == "line":
        head = rng.uniform(0.0, 2.0 * math.pi)
        off = rng.uniform(-mix["max_offset_m"], mix["max_offset_m"], 2)
        d = np.array([math.cos(head), math.sin(head)])
        s = (np.arange(n) - (n - 1) / 2.0) * step
        xy = off[None, :] + s[:, None] * d[None, :]
        return np.stack([yaw_pose(x, y, z, head) for x, y in xy])
    raise ValueError(f"unknown path {mix['path']!r}")


def windows(mix: dict) -> List[tuple]:
    return [tuple(w) for w in mix.get("robot_windows",
                                      [[0, mix["episode_frames"]]])]


def block_rows(mix: dict, block: int) -> np.ndarray:
    """(n_blocks, R*B) episode frame index of each row of each block."""
    wins = windows(mix)
    n_local = {b - a for a, b in wins}
    if len(n_local) != 1 or next(iter(n_local)) % block:
        raise ValueError("robot windows must share one length, a whole "
                         "number of blocks")
    n_local = n_local.pop()
    idx = [[a + b0 + i for a, _ in wins for i in range(block)]
           for b0 in range(0, n_local, block)]
    return np.asarray(idx, np.int64).reshape(n_local // block,
                                             len(wins) * block)


class Episode(NamedTuple):
    index: int            # in the pool
    truth: np.ndarray     # (episode_frames, 7) ground-truth poses
    rows: np.ndarray      # (n_blocks, R*B) episode frame of each row
    raw: torch.Tensor     # (n_blocks, R*B, raw_points, 3) float32
    mask: torch.Tensor    # (n_blocks, R*B, raw_points) bool


def make_pool(cfg: dict, mix: dict, device, seed: int,
              episodes: Optional[int] = None) -> List[Episode]:
    """The pool's episodes (the first `episodes` of them, or all), each
    with its own world and scans made on `device` from (seed, episode)."""
    w = cfg["world"]
    rows = block_rows(mix, cfg["block_frames"])
    pool = []
    for e in range(mix["pool_episodes"] if episodes is None else episodes):
        world = worldlib.build_world(
            worldlib.generator(device, seed, e, 0), device, w["extent"],
            w["n_ground"], w["n_pillars"], w["n_walls"])
        truth = path_poses(mix, seed, e)
        pts, msk = worldlib.scans(
            world, torch.as_tensor(truth, device=device),
            worldlib.generator(device, seed, e, 1),
            cfg["raw_points"],
            w["noise"], w["max_range"], w["min_range"])
        flat = torch.as_tensor(rows.reshape(-1), device=device)
        shape = rows.shape
        pool.append(Episode(e, truth, rows,
                            pts[flat].reshape(shape + pts.shape[1:]),
                            msk[flat].reshape(shape + msk.shape[1:])))
        del pts, msk, world
    return pool
