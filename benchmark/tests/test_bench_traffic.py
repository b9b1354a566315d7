"""The episode and block generator."""

import math

import numpy as np
import pytest
import torch

from benchmark import traffic, world


def test_fleet_blocks_lay_robots_side_by_side():
    mix = {"episode_frames": 160,
           "robot_windows": [[0, 60], [33, 93], [66, 126], [100, 160]]}
    rows = traffic.block_rows(mix, 12)
    assert rows.shape == (5, 48)
    assert rows[0, :12].tolist() == list(range(12))
    assert rows[0, 12:24].tolist() == list(range(33, 45))
    assert rows[4, 36:].tolist() == list(range(148, 160))


def test_single_robot_blocks_cover_the_episode():
    rows = traffic.block_rows({"episode_frames": 320}, 32)
    assert rows.shape == (10, 32)
    assert rows.reshape(-1).tolist() == list(range(320))


def test_windows_of_other_lengths_are_refused():
    with pytest.raises(ValueError):
        traffic.block_rows({"episode_frames": 30, "robot_windows": [[0, 10],
                                                                     [5, 20]]},
                           5)
    with pytest.raises(ValueError):
        traffic.block_rows({"episode_frames": 30}, 7)


def test_seed_words_take_any_whole_number():
    for seed in (0, 1, 5, 2 ** 31 + 11, 10 ** 12, 2 ** 70 + 3, -4):
        w = traffic._seed_words(seed)
        assert all(0 <= x < 2 ** 32 for x in w)
        np.random.default_rng(w + [1])
    assert traffic._seed_words(2 ** 32) != traffic._seed_words(0)
    assert traffic._seed_words(-4) != traffic._seed_words(4)


@pytest.mark.parametrize("name", ["revisit", "explore", "survey"])
def test_paths_step_as_the_mix_says(name):
    mix = traffic.load_mix(name)
    seed = 2 ** 31 + 77
    p = traffic.path_poses(mix, seed, 1)
    assert p.shape == (mix["episode_frames"], 7)
    step = np.linalg.norm(np.diff(p[:, :2], axis=0), axis=1)
    assert step == pytest.approx(mix["step_m"], rel=1e-4)
    assert np.linalg.norm(p[:, 3:], axis=1) == pytest.approx(1.0)
    # the path comes from the seed and the episode, and so does its length
    assert np.array_equal(p, traffic.path_poses(mix, seed, 1))
    assert not np.array_equal(p, traffic.path_poses(mix, seed, 2))
    q = traffic.path_poses(mix, seed + 1, 1)
    assert not np.array_equal(p, q) and q.shape == p.shape


def test_line_heads_along_itself():
    p = traffic.path_poses(traffic.load_mix("explore"), 5, 0)
    d = p[-1, :2] - p[0, :2]
    yaw = 2 * math.atan2(p[0, 6], p[0, 3])
    assert math.atan2(d[1], d[0]) == pytest.approx(
        math.atan2(math.sin(yaw), math.cos(yaw)), abs=1e-9)


def _small():
    cfg = {"world": {"extent": 10.0, "n_ground": 3000, "n_pillars": 2,
                     "n_walls": 1, "noise": 0.02, "max_range": 35.0,
                     "min_range": 0.5},
           "block_frames": 2, "raw_points": 2048}
    mix = {"path": "circle", "radius_m": 4.0, "step_m": 0.5, "z_m": 1.5,
           "episode_frames": 6, "pool_episodes": 2,
           "robot_windows": [[0, 4], [2, 6]]}
    return cfg, mix


def test_pool_is_made_from_the_seed():
    cfg, mix = _small()
    a = traffic.make_pool(cfg, mix, "cpu", 2 ** 33 + 5)
    b = traffic.make_pool(cfg, mix, "cpu", 2 ** 33 + 5)
    c = traffic.make_pool(cfg, mix, "cpu", 2 ** 33 + 6)
    assert len(a) == 2
    assert a[0].raw.shape == (2, 4, 2048, 3) and a[0].mask.shape == (2, 4,
                                                                     2048)
    assert torch.equal(a[1].raw, b[1].raw) and torch.equal(a[1].mask,
                                                          b[1].mask)
    assert not torch.equal(a[0].raw, a[1].raw)
    # another seed: other worlds and paths, the same sizes
    assert not torch.equal(a[0].raw, c[0].raw)
    assert not np.array_equal(a[0].truth, c[0].truth)
    assert c[0].raw.shape == a[0].raw.shape
    # robot 1's first row is episode frame 2, robot 0's third
    assert torch.equal(a[0].raw[0, 2], a[0].raw[1, 0])
    assert len(traffic.make_pool(cfg, mix, "cpu", 3, episodes=1)) == 1


def test_scans_are_in_range_in_the_sensor_frame():
    g = world.generator("cpu", 1)
    pts = world.build_world(g, "cpu", 10.0, 3000, 2, 1)
    pose = torch.tensor([[1.0, 2.0, 1.5, math.cos(0.3), 0, 0,
                          math.sin(0.3)]], dtype=torch.float64)
    s, m = world.scans(pts, pose, world.generator("cpu", 2), 8192, 0.0,
                       max_range=6.0)
    n = int(m.sum())
    assert 0 < n < 8192 and bool((s[0][~m[0]] == world.PAD).all())
    pts_in = s[0][m[0]]
    r = torch.linalg.vector_norm(pts_in, dim=-1)
    assert float(r.max()) < 6.0 and float(r.min()) > 0.5
    # back in the world frame every point is a world point
    R = world.quat_to_mat(pose[0, 3:].float())
    back = pts_in @ R.T + pose[0, :3].float()
    d = torch.cdist(back, pts,
                    compute_mode="donot_use_mm_for_euclid_dist").min(1).values
    assert float(d.max()) < 1e-4
