"""Command-line entry point of the port: the `ros2 launch mrg_slam
mrg_slam.launch.py` of this framework, on the CUDA card.

The JAX package's launch.py with the same arguments, datasets and
outputs, plus `--device`. It mirrors the reference launch surface
(launch/mrg_slam.launch.py): a YAML config (the reference's own
mrg_slam.yaml reads directly) and `param:=value` overrides (PARAM_MAPPING,
launch:13-54), then a full SLAM stack over a dataset:

    python -m mrg_slam_tpu_torch.launch --dataset synthetic \\
        model_namespace:=atlas x:=0.0 y:=0.0 registration_method:=SMALL_GICP
    python -m mrg_slam_tpu_torch.launch --dataset kitti \\
        --kitti-root /data/kitti --sequence 00 --config mrg_slam.yaml \\
        --output results/
    python -m mrg_slam_tpu_torch.launch --dataset rosbag --bag run1.db3 \\
        --topic /husky1/velodyne_points
    python -m mrg_slam_tpu_torch.launch --dataset rosbag --bag fleet.db3 \\
        --robots husky1,husky2

Outputs in --output: trajectory_tum.txt, map.pcd, graph/ (a saved graph,
models/persistence.py), graph.ply and summary.json; with --robots,
<robot>/graph/ per robot and one summary.json. Runs on the card unless
`--device` names another device (`--device cpu` runs the kernels' plain
versions); with no card and no --device it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .runtime import resolve_device

_SECTIONS = ("prefiltering_component", "scan_matching_odometry_component",
             "floor_detection_component", "mrg_slam_component")


def _parse_overrides(tokens):
    """`key:=value` tokens -> {key: value}; a value is read as JSON where
    it parses, else kept as a string."""
    out = {}
    for t in tokens:
        if ":=" not in t:
            raise SystemExit(f"override '{t}' is not of the form key:=value")
        k, v = t.split(":=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _apply_overrides(cfg_dict: dict, overrides: dict) -> dict:
    """Write flat key:=value overrides into every component section (the
    reference's PARAM_MAPPING pushes one flat namespace into every
    component's parameters; EngineConfig.from_yaml_dict keeps the fields
    each dataclass declares)."""
    for section in _SECTIONS:
        params = cfg_dict.setdefault(section, {})
        inner = params.get("ros__parameters", params)
        inner.update(overrides)
    return cfg_dict


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--config", help="YAML config (reference format ok)")
    ap.add_argument("--dataset", choices=["synthetic", "kitti", "rosbag"],
                    default="synthetic")
    ap.add_argument("--kitti-root")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--bag")
    ap.add_argument("--topic", default="/velodyne_points")
    ap.add_argument("--robots",
                    help="comma-separated robot namespaces: multi-robot "
                         "fleet SLAM from one bag, one namespaced topic "
                         "per robot (the reference's Nebula fleet shape)")
    ap.add_argument("--topic-template", default="/{robot}/velodyne_points")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--radius", type=float, default=18.0,
                    help="synthetic circle radius (m)")
    ap.add_argument("--laps", type=float, default=1.2,
                    help="synthetic circle laps over --frames")
    ap.add_argument("--tick-every", type=int, default=30)
    ap.add_argument("--fused", action="store_true",
                    help="batched replay (one odometry pass per tick "
                         "block; the per-frame replay when floor "
                         "detection, deskewing or an odometry front end "
                         "is on)")
    ap.add_argument("--output", default="results")
    ap.add_argument("--device",
                    help="torch device to run on (default: the CUDA "
                         "card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("overrides", nargs="*", help="param:=value overrides")
    return ap


def _config(args):
    from .config import EngineConfig

    d = {}
    if args.config:
        import yaml

        with open(args.config) as f:
            d = yaml.safe_load(f) or {}
    # the same flat fan-out with or without a file: an override lands in
    # every component section, and each dataclass keeps what it declares
    return EngineConfig.from_yaml_dict(
        _apply_overrides(d, _parse_overrides(args.overrides)))


def _inter_robot_loops(db) -> int:
    return sum(1 for e in db.edges if e.type == "loop"
               and db.uuid_keyframe_map[e.from_uuid].robot_name
               != db.uuid_keyframe_map[e.to_uuid].robot_name)


def _run_fleet(args, cfg, out_dir: Path) -> dict:
    """Fleet SLAM from one bag (pipeline/bagfleet.py): one stack a robot
    topic, lock-step replay with the uuid-delta graph exchange."""
    from .models.persistence import save_graph
    from .pipeline.bagfleet import run_fleet_from_bag

    names = [n.strip() for n in args.robots.split(",") if n.strip()]
    robots, results = run_fleet_from_bag(
        cfg, args.bag, names, topic_template=args.topic_template,
        tick_every=args.tick_every, max_frames=max(args.frames, 0),
        device=args.device)
    summary = {}
    for name in names:
        rdir = out_dir / name
        rdir.mkdir(parents=True, exist_ok=True)
        save_graph(robots[name].slam, rdir / "graph")
        db = robots[name].slam.db
        summary[name] = {
            "frames": int(len(results[name].stamps)),
            "keyframes": int(len(db.keyframes) + len(db.new_keyframes)),
            "loops": results[name].num_loops,
            "inter_robot_loops": _inter_robot_loops(db),
        }
    return summary


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    # the card unless --device says otherwise: without one this raises
    # here, before any dataset is read
    args.device = resolve_device(args.device)
    cfg = _config(args)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.dataset == "rosbag" and args.robots:
        summary = _run_fleet(args, cfg, out_dir)
        (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
        print(json.dumps(summary))
        return 0

    from .io.pcd import save_pcd
    from .models.markers import export_ply
    from .models.persistence import save_graph
    from .pipeline.replay import Robot, replay, replay_fused

    robot = Robot(cfg, device=args.device)
    gt_xyz, bag = None, None
    if args.dataset == "kitti":
        from .io.kitti import KittiSequence

        seq = KittiSequence.open(args.kitti_root, args.sequence)
        n = min(len(seq), args.frames) if args.frames > 0 else len(seq)
        frames = ((seq.times[i], seq.scan(i)) for i in range(n))
        if seq.gt_poses_velo is not None:
            gt_xyz = seq.gt_poses_velo[:n, :3, 3]
    elif args.dataset == "rosbag":
        from .io.rosbag import BagReader

        bag = BagReader(args.bag)
        frames = bag.pointclouds(args.topic)
    else:
        from .io.synthetic import SyntheticWorld, circle_trajectory

        world = SyntheticWorld.build(seed=0)
        traj = circle_trajectory(args.frames, radius=args.radius,
                                 laps=args.laps)
        frames = ((i * 0.1, world.scan(p, seed=i))
                  for i, p in enumerate(traj))
        gt_xyz = traj[:, :3]

    run = replay_fused if args.fused else replay
    try:
        result = run(robot, frames, tick_every=args.tick_every,
                     gt_xyz=gt_xyz,
                     tum_path=str(out_dir / "trajectory_tum.txt"))
    finally:
        if bag is not None:
            bag.close()

    map_pts = robot.slam.generate_map()
    save_pcd(out_dir / "map.pcd", map_pts)
    save_graph(robot.slam, out_dir / "graph")
    export_ply(robot.slam, out_dir / "graph.ply")
    db = robot.slam.db
    summary = {
        "frames": int(len(result.stamps)),
        "keyframes": int(len(db.keyframes) + len(db.new_keyframes)),
        "loops": result.num_loops,
        "ate_rmse": result.ate,
        "rpe_rmse": result.rpe,
        "frames_per_s": result.frames_per_s,
        "map_points": int(len(map_pts)),
    }
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
