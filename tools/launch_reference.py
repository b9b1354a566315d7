"""The JAX package's launch path on the CPU, with the numbers the PyTorch
port's `chip_smoke.py` holds its launch phase to (`REF_LAUNCH` there).

Runs what the smoke's launch phase runs, through the JAX package:

- session 1: `python -m mrg_slam_tpu.launch --dataset rosbag` in process
  over a bag (the JAX package's `write_bag`) of the first LAUNCH_FRAMES
  frames of the full-SLAM world (bench.py's production world, 131072 raw
  points a scan), with bench's configs as a YAML in the reference's
  layout and LAUNCH_OVERRIDES on the command line (`chip_smoke.
  launch_yaml`, `launch_argv`); the ATE of the saved keyframe estimates
  (`chip_smoke.keyframe_ate`) and of the CLI's per-frame TUM trajectory,
  keyframes, loops and map points from its summary;
- session 2: a fresh `Robot` (own name "session2", its init pose frame
  LAUNCH_FRAMES's true pose in session 1's map frame) that `load_graph`s
  session 1's graph directory and replays frames LAUNCH_FRAMES to
  SLAM_FRAMES - 1: its own keyframes' ATE, own keyframes, merged
  keyframes, loops and loops to loaded keyframes;
- the fleet bag of tests/test_rosbag_and_launch.py (`write_multi_bag`,
  atlas frames 0-47, bestla 32-79 of row 4's world) through
  `run_fleet_from_bag` with the test's init poses: per robot keyframes,
  loops, inter-robot loops, remote keyframes and its own keyframes' ATE.

It also checks that the port's `write_bag` writes the same message bytes
as the JAX package's for the session 1 bag. `--fused` runs session 1 with
the CLI's `--fused` and session 2 with `replay_fused`.

    python tools/launch_reference.py [--fused] [--work DIR]
        [--reuse-session1]

Runs on the CPU; expect tens of minutes at full width. Prints one JSON
line per part, then the dict that `chip_smoke.py` keeps as REF_LAUNCH.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import yaml  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mrg_slam_tpu import launch  # noqa: E402
from mrg_slam_tpu.config import EngineConfig  # noqa: E402
from mrg_slam_tpu.io.rosbag import (BagReader, write_bag,  # noqa: E402
                                    write_multi_bag)
from mrg_slam_tpu.io.synthetic import (SyntheticWorld,  # noqa: E402
                                       circle_trajectory)
from mrg_slam_tpu.models.persistence import load_graph  # noqa: E402
from mrg_slam_tpu.pipeline import baseline_runs as bl  # noqa: E402
from mrg_slam_tpu.pipeline.bagfleet import run_fleet_from_bag  # noqa: E402
from mrg_slam_tpu.pipeline.replay import (Robot, replay,  # noqa: E402
                                          replay_fused)
from mrg_slam_tpu.utils import se3np  # noqa: E402
from mrg_slam_tpu.utils.metrics import ate_rmse  # noqa: E402
from mrg_slam_tpu.utils.tum import load_tum  # noqa: E402
from mrg_slam_tpu_torch.io import rosbag as port_rosbag  # noqa: E402


def log(msg):
    print(msg, flush=True)


def same_bag_bytes(bag, frames):
    """Every message of the JAX package's bag equals the port's
    serialization of the same frame."""
    r = BagReader(str(bag))
    try:
        for (stamp, pts), (_, payload) in zip(
                frames, r.messages(cs.LAUNCH_TOPIC)):
            if payload != port_rosbag.serialize_pointcloud2(
                    stamp, "velodyne", pts):
                return False
    finally:
        r.close()
    return True


def bench_frames():
    """The full-SLAM world's first SLAM_FRAMES frames and their truth."""
    world = SyntheticWorld.build(seed=11, extent=60.0, n_ground=400000,
                                 n_pillars=150, n_walls=40,
                                 max_points_per_scan=cs.RAW, noise=0.02)
    traj = circle_trajectory(cs.TRAJ_FRAMES, radius=20.0,
                             laps=3.02)[:cs.SLAM_FRAMES]
    return traj, [(i * 0.1, world.scan(p, seed=i)[:cs.RAW])
                  for i, p in enumerate(traj)]


def session1(work, traj, frames, fused, reuse):
    """Session 1 through the JAX package's CLI (its outputs in
    work/session1; with `reuse`, those of an earlier run there)."""
    n1 = cs.LAUNCH_FRAMES
    bag = work / "session1.db3"
    config = work / "launch.yaml"
    out1 = work / "session1"
    s1_s = None
    if not (reuse and (out1 / "summary.json").exists()):
        bag.unlink(missing_ok=True)
        write_bag(str(bag), cs.LAUNCH_TOPIC, frames[:n1])
        config.write_text(yaml.safe_dump(cs.launch_yaml()))
        t0 = time.perf_counter()
        launch.main(cs.launch_argv(config, bag, out1, fused))
        s1_s = time.perf_counter() - t0
    summary = json.loads((out1 / "summary.json").read_text())
    _, poses = load_tum(out1 / "trajectory_tum.txt")
    s1 = dict(ate_m=cs.keyframe_ate(cs.saved_keyframes(out1 / "graph"),
                                    traj, ate_rmse),
              ate_frames_m=ate_rmse(poses[:, :3], traj[:n1, :3]),
              keyframes=summary["keyframes"], loops=summary["loops"],
              map_points=summary["map_points"], frames=summary["frames"],
              seconds=s1_s,
              bag_bytes_equal_port=same_bag_bytes(bag, frames[:n1]))
    log(json.dumps({"session1": s1}))
    return s1


def session2(work, traj, frames, fused):
    """A fresh Robot loads session 1's graph and replays the frames after
    it."""
    n1 = cs.LAUNCH_FRAMES
    cfg = EngineConfig.from_yaml_dict(launch._apply_overrides(
        yaml.safe_load((work / "launch.yaml").read_text()),
        launch._parse_overrides(cs.LAUNCH_OVERRIDES)))
    cfg2 = dataclasses.replace(cfg, slam=dataclasses.replace(
        cfg.slam, own_name=cs.SESSION2, multi_robot_names=(cs.SESSION2,),
        init_pose=cs.session2_init_pose(traj, se3np)))
    t0 = time.perf_counter()
    robot = Robot(cfg2)
    loaded = load_graph(robot.slam, work / "session1" / "graph")
    (replay_fused if fused else replay)(robot, frames[n1:],
                                        tick_every=cs.LAUNCH_TICK)
    db = robot.slam.db
    s2 = dict(ate_m=cs.keyframe_ate(cs.own_keyframes(db, cs.SESSION2),
                                    traj, ate_rmse),
              loaded=loaded, **cs.session2_counts(db),
              seconds=time.perf_counter() - t0)
    log(json.dumps({"session2": s2}))
    return s2


def fleet(work):
    world = bl._world()
    traj = circle_trajectory(cs.FLEET_FRAMES, radius=14.0, laps=1.0)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    a, b = cs.FLEET_NAMES
    bag = work / "fleet.db3"
    bag.unlink(missing_ok=True)
    write_multi_bag(str(bag), {
        f"/{a}/velodyne_points": frames[:cs.FLEET_WINDOW],
        f"/{b}/velodyne_points": frames[cs.FLEET_START_B:]})
    cfg = bl._base_cfg()
    cfg = dataclasses.replace(cfg, slam=dataclasses.replace(
        cfg.slam, exchange=dataclasses.replace(
            cfg.slam.exchange, graph_request_min_time_delay=0.5,
            graph_request_min_accum_dist=1.0)))
    t0 = time.perf_counter()
    robots, _ = run_fleet_from_bag(
        cfg, str(bag), list(cs.FLEET_NAMES), tick_every=cs.FLEET_TICK,
        init_poses={a: cs.init_pose_of(traj[0]),
                    b: cs.init_pose_of(traj[cs.FLEET_START_B])})
    out = cs.fleet_metrics(robots, traj, ate_rmse)
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps({"fleet": out}))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--work", help="directory for the bags and outputs "
                                   "(default: a temporary one)")
    ap.add_argument("--reuse-session1", action="store_true",
                    help="take session 1's outputs from an earlier run "
                         "in --work")
    args = ap.parse_args()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(args.work or tmp)
        work.mkdir(parents=True, exist_ok=True)
        traj, frames = bench_frames()
        s1 = session1(work, traj, frames, args.fused, args.reuse_session1)
        s2 = session2(work, traj, frames, args.fused)
        del frames
        fl = fleet(work)
    ref = dict(
        fused=args.fused,
        session1={k: s1[k] for k in ("ate_m", "ate_frames_m", "keyframes",
                                     "loops", "map_points")},
        session2={k: s2[k] for k in ("ate_m", "keyframes",
                                     "merged_keyframes", "loops",
                                     "loaded_loops")},
        fleet={n: {k: fl[n][k] for k in ("ate_m", "keyframes", "loops",
                                         "inter_robot_loops",
                                         "remote_keyframes")}
               for n in cs.FLEET_NAMES})
    log(f"# {time.perf_counter() - t0:.0f} s on the CPU")
    log(f"REF_LAUNCH = {ref!r}")


if __name__ == "__main__":
    main()
