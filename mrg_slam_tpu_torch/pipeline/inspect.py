"""Run and dataset inspection: stats and plots.

Counterpart of the JAX package's pipeline/inspect.py (host numpy over
files; nothing here touches a device), the no-ROS equivalent of
python_scripts/kitti_inspector.py and nebula_multirobot_inspector.py:
summarize a saved graph directory (keyframes, edges, loops, per-robot
chains, timing and network stats) or a KITTI sequence (scan sizes,
durations, ground-truth path), and render top-down trajectory and graph
plots. A graph directory saved by either package reads the same (the two
`save_graph` layouts are one).

CLI (`python -m mrg_slam_tpu_torch.pipeline.inspect ...`):
    ... <graph_dir>                          # a run
    ... <kitti_root> --seq 00                # a dataset
    ... compare <dirA> <dirB> [--out <dir>]  # two runs
Writes <out>/inspection.json (and .png plots when matplotlib is there).

`compare` is the run-vs-run report the reference inspectors build for
result comparison (kitti_inspector.py's result plots and tables):
per-robot keyframe and loop deltas, trajectory RMSE between the two runs
at common stamps (raw and Umeyama-aligned), a per-edge-type chi2
breakdown of each run evaluated at its saved estimates, and an overlay
plot.
"""

from __future__ import annotations

import json
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..utils import se3np
from ..utils.metrics import umeyama_alignment


def _load_kv(path: Path) -> Dict[str, str]:
    out = {}
    for line in path.read_text().splitlines():
        k, _, v = line.partition(" ")
        out[k] = v
    return out


def inspect_graph_dir(directory: str,
                      out_dir: Optional[str] = None) -> Dict:
    """Stats + plots for a save_graph directory (persistence layout)."""
    d = Path(directory)
    out = Path(out_dir) if out_dir else d
    kdirs = sorted((d / "keyframes").iterdir()) if (d / "keyframes").exists() \
        else []
    kfs = []
    for kdir in kdirs:
        meta = _load_kv(kdir / "data.txt")
        kfs.append(dict(
            robot=meta["robot_name"], stamp=float(meta["stamp"]),
            accum=float(meta["accum_distance"]),
            est=np.asarray([float(v) for v in meta["estimate"].split()]),
            first=bool(int(meta["first_keyframe"])),
            static=bool(int(meta["static_keyframe"])),
            has_floor="floor_coeffs" in meta, has_gps="utm_coord" in meta,
            has_imu="orientation" in meta or "acceleration" in meta))
    edges = []
    if (d / "edges").exists():
        for edir in sorted((d / "edges").iterdir()):
            meta = _load_kv(edir / "data.txt")
            edges.append(dict(type=meta["type"],
                              kernel=meta.get("robust_kernel", "NONE"),
                              from_uuid=meta["from_uuid_str"],
                              to_uuid=meta["to_uuid_str"]))
    robots = Counter(k["robot"] for k in kfs)
    edge_types = Counter(e["type"] for e in edges)
    per_robot = {}
    for name in robots:
        own = [k for k in kfs if k["robot"] == name]
        xyz = np.stack([k["est"][:3] for k in own]) if own else np.zeros((0, 3))
        per_robot[name] = dict(
            keyframes=len(own),
            accum_distance=max((k["accum"] for k in own), default=0.0),
            bbox_min=xyz.min(0).tolist() if len(xyz) else None,
            bbox_max=xyz.max(0).tolist() if len(xyz) else None)
    stats = dict(
        directory=str(d), keyframes=len(kfs), edges=len(edges),
        robots=dict(robots), edge_types=dict(edge_types),
        loops=edge_types.get("loop", 0),
        keyframes_with_floor=sum(k["has_floor"] for k in kfs),
        keyframes_with_gps=sum(k["has_gps"] for k in kfs),
        keyframes_with_imu=sum(k["has_imu"] for k in kfs),
        static_keyframes=sum(k["static"] for k in kfs),
        per_robot=per_robot)
    for aux in ("timing_stats.txt", "network_stats.txt"):
        if (d / aux).exists():
            stats[aux.replace(".txt", "")] = _load_kv(d / aux)

    out.mkdir(parents=True, exist_ok=True)
    with open(out / "inspection.json", "w") as f:
        json.dump(stats, f, indent=2, default=str)
    png = _plot_graph(kfs, edges, out / "trajectory.png")
    if png:
        stats["plot"] = png
    return stats


def _plot_graph(kfs, edges, path: Path) -> Optional[str]:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib optional
        return None
    if not kfs:
        return None
    fig, ax = plt.subplots(figsize=(7, 7))
    robots = sorted({k["robot"] for k in kfs})
    cmap = plt.get_cmap("tab10")
    for i, name in enumerate(robots):
        own = [k for k in kfs if k["robot"] == name]
        own.sort(key=lambda k: k["stamp"])
        xyz = np.stack([k["est"][:3] for k in own])
        ax.plot(xyz[:, 0], xyz[:, 1], ".-", ms=3, lw=0.8,
                color=cmap(i % 10), label=f"{name} ({len(own)} kf)")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend()
    ax.set_title(f"{len(kfs)} keyframes, "
                 f"{sum(1 for e in edges if e['type'] == 'loop')} loops")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return str(path)


def _load_run(directory: str):
    """Load a save_graph directory into plain dicts (uuid-linked)."""
    d = Path(directory)
    kfs, edges = [], []
    if (d / "keyframes").exists():
        for kdir in sorted((d / "keyframes").iterdir()):
            meta = _load_kv(kdir / "data.txt")
            kfs.append(dict(
                uuid=meta["uuid_str"], robot=meta["robot_name"],
                stamp=float(meta["stamp"]),
                accum=float(meta["accum_distance"]),
                est=np.asarray([float(v) for v in
                                meta["estimate"].split()], np.float32),
                first=bool(int(meta["first_keyframe"])),
                static=bool(int(meta["static_keyframe"]))))
    if (d / "edges").exists():
        for edir in sorted((d / "edges").iterdir()):
            meta = _load_kv(edir / "data.txt")
            edges.append(dict(
                type=meta["type"], from_uuid=meta["from_uuid_str"],
                to_uuid=meta["to_uuid_str"],
                kernel=meta.get("robust_kernel", "NONE"),
                relative_pose=np.asarray(
                    [float(v) for v in meta["relative_pose"].split()],
                    np.float32),
                information=np.asarray(
                    [float(v) for v in meta["information"].split()],
                    np.float32).reshape(6, 6)))
    return kfs, edges


def edge_chi2_breakdown(kfs, edges) -> Dict:
    """Per-edge-type chi2 of a run at its saved estimates — the
    graph-quality oracle the reference prints per optimize
    (graph_slam.cpp:368-393), split by edge family and robot-pair kind."""
    est = {k["uuid"]: k["est"] for k in kfs}
    robot = {k["uuid"]: k["robot"] for k in kfs}
    out: Dict[str, Dict] = {}
    for e in edges:
        a, b = est.get(e["from_uuid"]), est.get(e["to_uuid"])
        if a is None or b is None:
            continue
        r = se3np.pose_error(e["relative_pose"], a, b)
        chi2 = float(r @ e["information"] @ r)
        keys = [e["type"]]
        if e["type"] == "loop":
            keys.append("loop_inter_robot"
                        if robot[e["from_uuid"]] != robot[e["to_uuid"]]
                        else "loop_same_robot")
        for key in keys:
            s = out.setdefault(key, dict(count=0, chi2_total=0.0,
                                         chi2_max=0.0))
            s["count"] += 1
            s["chi2_total"] += chi2
            s["chi2_max"] = max(s["chi2_max"], chi2)
    for s in out.values():
        s["chi2_mean"] = s["chi2_total"] / max(s["count"], 1)
    return out


def compare_graph_dirs(dir_a: str, dir_b: str,
                       out_dir: Optional[str] = None) -> Dict:
    """Run-vs-run comparison report (reference: kitti_inspector.py's
    multi-run result tables/plots). Returns + writes comparison.json and
    an overlay trajectory plot."""
    runs = {}
    for tag, d in (("a", dir_a), ("b", dir_b)):
        kfs, edges = _load_run(d)
        runs[tag] = dict(dir=str(d), kfs=kfs, edges=edges)

    report: Dict = {"run_a": dir_a, "run_b": dir_b}
    for tag, run in runs.items():
        kfs, edges = run["kfs"], run["edges"]
        loops = [e for e in edges if e["type"] == "loop"]
        robot = {k["uuid"]: k["robot"] for k in kfs}
        inter = sum(1 for e in loops
                    if robot.get(e["from_uuid"]) != robot.get(e["to_uuid"]))
        report[f"summary_{tag}"] = dict(
            keyframes=len(kfs), edges=len(edges), loops=len(loops),
            inter_robot_loops=inter,
            robots=dict(Counter(k["robot"] for k in kfs)),
            chi2_by_edge_type=edge_chi2_breakdown(kfs, edges))

    # per-robot trajectory deltas at common (robot, stamp) keys
    per_robot: Dict[str, Dict] = {}
    for name in sorted({k["robot"] for k in runs["a"]["kfs"]}
                       & {k["robot"] for k in runs["b"]["kfs"]}):
        ka = {round(k["stamp"], 6): k["est"] for k in runs["a"]["kfs"]
              if k["robot"] == name}
        kb = {round(k["stamp"], 6): k["est"] for k in runs["b"]["kfs"]
              if k["robot"] == name}
        common = sorted(set(ka) & set(kb))
        if len(common) < 2:
            per_robot[name] = dict(common_stamps=len(common))
            continue
        xa = np.stack([ka[s][:3] for s in common])
        xb = np.stack([kb[s][:3] for s in common])
        raw = float(np.sqrt(np.mean(np.sum((xa - xb) ** 2, axis=1))))
        R, t, s = umeyama_alignment(xa, xb)
        aligned = float(np.sqrt(np.mean(np.sum(
            ((s * xa @ R.T + t) - xb) ** 2, axis=1))))
        per_robot[name] = dict(
            common_stamps=len(common),
            only_a=len(ka) - len(common), only_b=len(kb) - len(common),
            rmse_raw_m=raw, rmse_aligned_m=aligned,
            max_delta_m=float(np.abs(xa - xb).max()))
    report["per_robot_delta"] = per_robot

    out = Path(out_dir) if out_dir else Path(dir_a)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "comparison.json", "w") as f:
        json.dump(report, f, indent=2, default=str)
    png = _plot_overlay(runs, out / "comparison.png")
    if png:
        report["plot"] = png
    return report


def _plot_overlay(runs, path: Path) -> Optional[str]:
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib optional
        return None
    fig, ax = plt.subplots(figsize=(7, 7))
    cmap = plt.get_cmap("tab10")
    styles = {"a": "-", "b": "--"}
    names = sorted({k["robot"] for run in runs.values()
                    for k in run["kfs"]})
    for tag, run in runs.items():
        for i, name in enumerate(names):
            own = sorted((k for k in run["kfs"] if k["robot"] == name),
                         key=lambda k: k["stamp"])
            if not own:
                continue
            xyz = np.stack([k["est"][:3] for k in own])
            ax.plot(xyz[:, 0], xyz[:, 1], styles[tag], lw=1.0,
                    color=cmap(i % 10), label=f"{name} ({tag})")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(fontsize=8)
    ax.set_title("run A (solid) vs run B (dashed)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return str(path)


def inspect_kitti(root: str, sequence: str,
                  out_dir: Optional[str] = None,
                  max_scans: int = 50) -> Dict:
    """Dataset statistics for a KITTI odometry sequence."""
    from ..io.kitti import KittiSequence

    seq = KittiSequence.open(root, sequence)
    sizes = [len(seq.scan(i))
             for i in range(0, len(seq), max(1, len(seq) // max_scans))]
    stats = dict(root=str(root), sequence=sequence, scans=len(seq),
                 duration_s=float(seq.times[-1] - seq.times[0])
                 if len(seq.times) else 0.0,
                 points_per_scan=dict(
                     mean=float(np.mean(sizes)), min=int(np.min(sizes)),
                     max=int(np.max(sizes))))
    if seq.gt_poses_velo is not None:
        t = seq.gt_poses_velo[:, :3, 3]
        stats["gt_path_length_m"] = float(
            np.sum(np.linalg.norm(np.diff(t, axis=0), axis=1)))
        stats["gt_bbox_min"] = t.min(0).tolist()
        stats["gt_bbox_max"] = t.max(0).tolist()
    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "inspection.json", "w") as f:
            json.dump(stats, f, indent=2)
        if seq.gt_poses_velo is not None:
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                t = seq.gt_poses_velo[:, :3, 3]
                fig, ax = plt.subplots(figsize=(7, 7))
                ax.plot(t[:, 0], t[:, 1], lw=1.0)
                ax.set_aspect("equal")
                ax.set_title(f"KITTI {sequence} ground truth")
                fig.savefig(out / "gt_trajectory.png", dpi=110)
                plt.close(fig)
            except Exception:
                pass
    return stats


def main(argv=None) -> Dict:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return {}
    target = argv[0]
    if target == "compare":
        out = None
        if "--out" in argv:
            out = argv[argv.index("--out") + 1]
        stats = compare_graph_dirs(argv[1], argv[2], out_dir=out)
        print(json.dumps(stats, indent=2, default=str))
        return stats
    if "--seq" in argv:
        seq = argv[argv.index("--seq") + 1]
        stats = inspect_kitti(target, seq, out_dir=target)
    else:
        stats = inspect_graph_dir(target)
    print(json.dumps(stats, indent=2, default=str))
    return stats


if __name__ == "__main__":
    main()
