"""The port's command-line entry point (`python -m
mrg_slam_tpu_torch.launch`, the JAX package's launch.py with `--device`)
on the CPU: its output contract on every dataset, and its runs against
the port's own library calls on the same frames.

- synthetic, at the JAX package's CLI test's tiny overrides
  (tests/test_rosbag_and_launch.py:40-66): every output file, and the
  frames, keyframes, loops, ATE and per-frame trajectory equal to
  `pipeline.replay.replay` of the same frames with the same config, on
  the same device (one deterministic program, so exactly;
  tests/test_torch_replay.py holds `replay` to the JAX package's);
- rosbag, one topic: the same frames written into a bag give the same
  trajectory file as the synthetic run (a bag holds float32 points
  losslessly, and stamps to the nanosecond);
- kitti on tests/data/kitti_mini (3 scans of 64 points);
- rosbag with --robots on a small two-topic bag: the fleet's contract
  (summary.json per robot, graph/ per robot).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from mrg_slam_tpu_torch import launch
from mrg_slam_tpu_torch.config import EngineConfig
from mrg_slam_tpu_torch.io.rosbag import write_bag, write_multi_bag
from mrg_slam_tpu_torch.io.synthetic import SyntheticWorld, circle_trajectory
from mrg_slam_tpu_torch.pipeline.replay import Robot, replay
from mrg_slam_tpu_torch.utils.tum import load_tum

DATA = Path(__file__).parent / "data"
FRAMES, TICK, LAPS = 16, 8, 0.15
# the JAX package's CLI test's overrides (distance_far_thresh keeps the
# voxelized scan under the 512-point capacity)
TINY = ["keyframe_delta_trans:=1.0", "downsample_resolution:=1.0",
        "distance_far_thresh:=12.0", "capacity_keyframes:=64",
        "capacity_edges:=256", "capacity_raw_points:=8192",
        "capacity_filtered_points:=512", "capacity_keyframe_points:=512",
        "outlier_removal_method:=NONE", "reg_maximum_iterations:=16"]
SUMMARY_KEYS = {"frames", "keyframes", "loops", "ate_rmse", "rpe_rmse",
                "frames_per_s", "map_points"}


def _frames():
    world = SyntheticWorld.build(seed=0)
    traj = circle_trajectory(FRAMES, radius=18.0, laps=LAPS)
    return traj, [(i * 0.1, world.scan(p, seed=i))
                  for i, p in enumerate(traj)]


def _contract(out: Path):
    summary = json.loads((out / "summary.json").read_text())
    assert set(summary) == SUMMARY_KEYS
    for f in ("trajectory_tum.txt", "map.pcd", "graph.ply",
              "graph/graph.g2o", "graph/special_nodes.csv"):
        assert (out / f).exists(), f
    n_kf = len(list((out / "graph" / "keyframes").iterdir()))
    assert n_kf == summary["keyframes"] >= 1
    header = (out / "map.pcd").read_bytes().split(b"DATA binary\n")[0]
    assert f"POINTS {summary['map_points']}\n".encode() in header
    assert len(np.loadtxt(out / "trajectory_tum.txt", ndmin=2)) \
        == summary["frames"]
    return summary


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("synthetic")
    rc = launch.main(["--device", "cpu", "--dataset", "synthetic",
                      "--frames", str(FRAMES), "--tick-every", str(TICK),
                      "--laps", str(LAPS), "--output", str(out)] + TINY)
    assert rc == 0
    return out


def test_cli_synthetic_equals_replay_of_the_same_frames(synthetic_run):
    summary = _contract(synthetic_run)
    assert summary["frames"] == FRAMES and summary["keyframes"] >= 3
    cfg = EngineConfig.from_yaml_dict(
        launch._apply_overrides({}, launch._parse_overrides(TINY)))
    assert cfg.prefilter.capacity_filtered_points == 512
    assert cfg.slam.capacity_keyframe_points == 512
    assert cfg.odometry.registration.reg_maximum_iterations == 16
    traj, frames = _frames()
    robot = Robot(cfg, device="cpu")
    res = replay(robot, frames, tick_every=TICK, gt_xyz=traj[:, :3])
    db = robot.slam.db
    assert summary["keyframes"] == len(db.keyframes) + len(db.new_keyframes)
    assert summary["loops"] == res.num_loops
    assert summary["ate_rmse"] == res.ate
    assert summary["rpe_rmse"] == res.rpe
    _, poses = load_tum(synthetic_run / "trajectory_tum.txt")
    np.testing.assert_allclose(poses[:, :3], res.trajectory[:, :3],
                               atol=1e-6)


def test_cli_rosbag_one_topic(synthetic_run, tmp_path):
    _, frames = _frames()
    bag = tmp_path / "run.db3"
    write_bag(str(bag), "/husky1/velodyne_points", frames)
    rc = launch.main(["--device", "cpu", "--dataset", "rosbag", "--bag",
                      str(bag), "--topic", "/husky1/velodyne_points",
                      "--tick-every", str(TICK), "--output",
                      str(tmp_path / "out")] + TINY)
    assert rc == 0
    summary = _contract(tmp_path / "out")
    assert summary["frames"] == FRAMES
    assert summary["ate_rmse"] is None  # a bag carries no ground truth
    syn = json.loads((synthetic_run / "summary.json").read_text())
    assert summary["keyframes"] == syn["keyframes"]
    assert summary["map_points"] == syn["map_points"]
    assert ((tmp_path / "out" / "trajectory_tum.txt").read_text()
            == (synthetic_run / "trajectory_tum.txt").read_text())


def test_cli_kitti_mini(tmp_path):
    rc = launch.main(["--device", "cpu", "--dataset", "kitti",
                      "--kitti-root", str(DATA / "kitti_mini"),
                      "--sequence", "00", "--tick-every", "2",
                      "--output", str(tmp_path / "out"),
                      "capacity_raw_points:=128",
                      "capacity_filtered_points:=64",
                      "capacity_keyframe_points:=64",
                      "capacity_keyframes:=16", "capacity_edges:=64",
                      "outlier_removal_method:=NONE",
                      "downsample_resolution:=0.05"])
    assert rc == 0
    summary = _contract(tmp_path / "out")
    assert summary["frames"] == 3
    # the fixture's ground truth is there, so ATE is computed
    assert summary["ate_rmse"] is not None
    stamps = np.loadtxt(tmp_path / "out" / "trajectory_tum.txt")[:, 0]
    np.testing.assert_allclose(stamps, [0.0, 0.1037, 0.2074], atol=1e-6)


def test_cli_fleet_from_a_two_topic_bag(tmp_path):
    world = SyntheticWorld.build(seed=3, extent=20.0, n_ground=4000,
                                 n_pillars=8, n_walls=4,
                                 max_points_per_scan=2048, noise=0.02)
    traj = circle_trajectory(12, radius=6.0, laps=0.4)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    bag = tmp_path / "fleet.db3"
    write_multi_bag(str(bag), {"/alpha/points": frames[:8],
                               "/bravo/points": frames[4:]})
    rc = launch.main(["--device", "cpu", "--dataset", "rosbag", "--bag",
                      str(bag), "--robots", "alpha, bravo",
                      "--topic-template", "/{robot}/points",
                      "--tick-every", "4", "--frames", "6",
                      "--output", str(tmp_path / "out"),
                      "capacity_raw_points:=2048",
                      "capacity_filtered_points:=256",
                      "capacity_keyframe_points:=256",
                      "capacity_keyframes:=32", "capacity_edges:=128",
                      "outlier_removal_method:=NONE",
                      "downsample_resolution:=0.5",
                      "keyframe_delta_trans:=0.5",
                      "reg_maximum_iterations:=8"])
    assert rc == 0
    summary = json.loads((tmp_path / "out" / "summary.json").read_text())
    assert list(summary) == ["alpha", "bravo"]
    for name, s in summary.items():
        assert set(s) == {"frames", "keyframes", "loops",
                          "inter_robot_loops"}
        assert s["frames"] == 6 and s["keyframes"] >= 1
        g = tmp_path / "out" / name / "graph"
        assert (g / "graph.g2o").exists()
        assert len(list((g / "keyframes").iterdir())) == s["keyframes"]
