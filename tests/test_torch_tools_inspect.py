"""The port's run tooling against the JAX package's: se3np.pose_log /
pose_error, the g2o and TUM tools (pipeline/tools.py), graph-directory,
run-vs-run and KITTI inspection (pipeline/inspect.py) and the stage timer
and trace hook (utils/profiling.py).

Both packages read the same files: a small chain saved by the port's
`save_graph`, the same chain loaded and saved again by the JAX
package's (the two layouts are one), and tests/data/kitti_mini.
Tolerances and why:
- pose_log / pose_error: both are the same float64 numpy with a float32
  result, so within 1e-6;
- the g2o and TUM tools and every report: the same numpy over the same
  files, so equal, floats within 1e-6 (rel); the report keys that name
  a path (`directory`, `run_a`, `run_b`, `plot`, `root`) are left out.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from mrg_slam_tpu import config as jconfig
from mrg_slam_tpu.models import persistence as jpersist
from mrg_slam_tpu.models.backend import MrgSlam as JMrgSlam
from mrg_slam_tpu.pipeline import inspect as jinspect
from mrg_slam_tpu.pipeline import tools as jtools
from mrg_slam_tpu.utils import se3np as jse3np
from mrg_slam_tpu.utils.tum import save_tum as jsave_tum

from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.models import persistence as tpersist
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.models.graph_database import Loop
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.pipeline import inspect as tinspect
from mrg_slam_tpu_torch.pipeline import tools as ttools
from mrg_slam_tpu_torch.utils import profiling, se3np

KITTI = Path(__file__).parent / "data" / "kitti_mini"
PATH_KEYS = ("directory", "run_a", "run_b", "plot", "root")


def _jcfg(name):
    return jconfig.SlamConfig(
        own_name=name, multi_robot_names=(name,),
        keyframe_delta_trans=0.5, capacity_keyframes=32, capacity_edges=128,
        capacity_keyframe_points=128,
        optimizer=jconfig.OptimizerConfig(solver_backend="dense",
                                          g2o_solver_num_iterations=16),
        inf_matrix=jconfig.InformationMatrixConfig(use_const_inf_matrix=True),
        loop=dataclasses.replace(jconfig.LoopClosureConfig(),
                                 capacity_candidates=2,
                                 candidate_max_xy_distance=0.0),
        robot_remove_points_radius=0.0)


def _saved_by_the_port(directory, seed=3, n=6):
    """A chain of n keyframes with GPS, IMU and floor attachments and a
    loop edge, ticked once on the CPU and saved by the port."""
    rng = np.random.default_rng(seed)
    slam = MrgSlam(config_from_fields(dataclasses.asdict(
        _jcfg("inspector"))), device="cpu")
    kfs = []
    for i in range(n):
        yaw = 0.1 * i
        odom = np.asarray([i * 1.0, 0.2 * i * i, 0.0, np.cos(yaw / 2), 0.0,
                           0.0, np.sin(yaw / 2)], np.float32)
        pts = rng.uniform(-2, 2, size=(48, 3)).astype(np.float32)
        kf = slam.db.add_odom_keyframe(
            float(i) * 0.5, odom, accum_distance=float(i),
            cloud=PointCloud.from_array(pts, capacity=128, device="cpu"))
        if i == 1:
            kf.floor_coeffs = np.asarray([0, 0, 1, -0.2], np.float32)
            kf.utm_coord = np.asarray([453000.1, 5428000.5, 110.25],
                                      np.float32)
        if i == 2:
            kf.acceleration = np.asarray([0.1, 0.0, 9.81], np.float32)
            kf.orientation = se3np.rpy_to_quat(0.0, 0.05, 0.2)
        kfs.append(kf)
    slam.optimization_tick(now=float(n))
    rel = se3np.pose_between(kfs[-1].odom, kfs[1].odom)
    rel[:3] += np.asarray([0.05, -0.03, 0.02], np.float32)
    slam.db.insert_loops([Loop(key1=kfs[-1], key2=kfs[1],
                               relative_pose=rel, fitness=0.05)])
    tpersist.save_graph(slam, directory)
    return Path(directory)


def _saved_by_the_jax_package(src, directory):
    """The JAX package's save of the port's directory: loaded, flushed
    without optimizing (estimates unchanged) and saved again by it."""
    slam = JMrgSlam(_jcfg("inspector"))
    jpersist.load_graph(slam, src)
    slam.db.flush_loaded_graph(slam.loop_detector.loop_manager)
    jpersist.save_graph(slam, directory)
    return Path(directory)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("saved")
    port = _saved_by_the_port(root / "port")
    return {"port": port,
            "jax": _saved_by_the_jax_package(port, root / "jax")}


def _same_report(a, b, path=""):
    """Equal reports: the same keys (paths left out), the same values,
    floats within 1e-6 relative."""
    if isinstance(a, dict):
        ka = {k for k in a if k not in PATH_KEYS}
        kb = {k for k in b if k not in PATH_KEYS}
        assert ka == kb, (path, ka ^ kb)
        for k in ka:
            _same_report(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_report(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-6, abs=1e-9), path
    else:
        assert a == b, path


def test_pose_log_and_pose_error_match_the_jax_package():
    rng = np.random.default_rng(5)
    for _ in range(20):
        q = rng.normal(size=(3, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        poses = np.concatenate([rng.normal(scale=3.0, size=(3, 3)), q],
                               axis=1).astype(np.float32)
        np.testing.assert_allclose(se3np.pose_log(poses[0]),
                                   jse3np.pose_log(poses[0]), atol=1e-6)
        np.testing.assert_allclose(se3np.pose_error(*poses),
                                   jse3np.pose_error(*poses), atol=1e-6)
    # the small-angle branch
    tiny = np.asarray([0.3, -0.1, 0.2, 1.0, 1e-7, 0.0, 0.0], np.float32)
    np.testing.assert_allclose(se3np.pose_log(tiny), jse3np.pose_log(tiny),
                               atol=1e-6)


def test_g2o_and_tum_tools_match_the_jax_package(saved, tmp_path):
    g2o = saved["port"] / "graph.g2o"
    poses = ttools.g2o_to_poses(g2o)
    np.testing.assert_array_equal(poses, jtools.g2o_to_poses(g2o))
    assert len(poses) == 6  # the fixed anchor left out
    n = ttools.g2o_to_tum(g2o, tmp_path / "port.tum")
    assert n == jtools.g2o_to_tum(g2o, tmp_path / "jax.tum") == 6
    assert ((tmp_path / "port.tum").read_bytes()
            == (tmp_path / "jax.tum").read_bytes())
    # an estimate against a noisy, shifted truth at other stamps
    rng = np.random.default_rng(8)
    gt = poses.copy()
    gt[:, :3] += rng.normal(scale=0.05, size=(len(gt), 3)) + [1.0, -2.0, 0]
    jsave_tum(tmp_path / "gt.tum", np.arange(len(gt)) * 0.1 + 0.02, gt)
    for align in (True, False):
        got = ttools.evaluate_tum(tmp_path / "port.tum", tmp_path / "gt.tum",
                                  align=align)
        want = jtools.evaluate_tum(tmp_path / "jax.tum", tmp_path / "gt.tum",
                                   align=align)
        _same_report(got.to_dict(), want.to_dict())
    ttools.write_report(got, tmp_path / "port.json")
    jtools.write_report(want, tmp_path / "jax.json")
    _same_report(json.loads((tmp_path / "port.json").read_text()),
                 json.loads((tmp_path / "jax.json").read_text()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_inspect_graph_dir_matches_the_jax_package(saved, tmp_path, writer):
    got = tinspect.inspect_graph_dir(saved[writer], out_dir=tmp_path / "p")
    want = jinspect.inspect_graph_dir(saved[writer], out_dir=tmp_path / "j")
    _same_report(got, want)
    assert got["keyframes"] == 6 and got["loops"] == 1
    assert got["keyframes_with_gps"] == got["keyframes_with_imu"] == 1
    _same_report(json.loads((tmp_path / "p" / "inspection.json")
                            .read_text()), got)


def test_compare_graph_dirs_matches_the_jax_package(saved, tmp_path):
    # run B: the port's directory with one estimate moved by 0.5 m
    b = tmp_path / "b"
    tpersist.save_graph(_load_flushed(saved["port"]), b)
    kdir = sorted((b / "keyframes").iterdir())[2]
    lines = (kdir / "data.txt").read_text().splitlines()
    for i, line in enumerate(lines):
        if line.startswith("estimate "):
            vals = [float(v) for v in line.split()[1:]]
            vals[0] += 0.5
            lines[i] = "estimate " + " ".join(f"{v:.9f}" for v in vals)
    (kdir / "data.txt").write_text("\n".join(lines) + "\n")
    for a in (saved["jax"], saved["port"]):
        got = tinspect.compare_graph_dirs(str(a), str(b),
                                          out_dir=str(tmp_path / "p"))
        want = jinspect.compare_graph_dirs(str(a), str(b),
                                           out_dir=str(tmp_path / "j"))
        _same_report(got, want)
    robot = got["per_robot_delta"]["inspector"]
    assert robot["common_stamps"] == 6 and 0.1 < robot["rmse_raw_m"] < 0.5
    chi2_a = got["summary_a"]["chi2_by_edge_type"]
    chi2_b = got["summary_b"]["chi2_by_edge_type"]
    assert chi2_b["odom"]["chi2_total"] > chi2_a["odom"]["chi2_total"]
    assert chi2_a["loop"]["count"] == chi2_a["loop_same_robot"]["count"] == 1
    assert (tmp_path / "p" / "comparison.json").exists()


def _load_flushed(directory):
    slam = MrgSlam(config_from_fields(dataclasses.asdict(_jcfg("loader"))),
                   device="cpu")
    tpersist.load_graph(slam, directory)
    slam.db.flush_loaded_graph(slam.loop_detector.loop_manager)
    return slam


def test_inspect_kitti_matches_the_jax_package(tmp_path):
    got = tinspect.inspect_kitti(KITTI, "00", out_dir=tmp_path / "p")
    want = jinspect.inspect_kitti(KITTI, "00", out_dir=tmp_path / "j")
    _same_report(got, want)
    assert got["scans"] == 3
    assert got["gt_path_length_m"] == pytest.approx(2.0, abs=1e-6)
    assert (tmp_path / "p" / "inspection.json").exists()


def test_inspect_cli_takes_its_three_forms(saved, tmp_path, capsys):
    assert tinspect.main([]) == {}
    stats = tinspect.main([str(saved["port"])])
    assert stats["keyframes"] == 6
    rep = tinspect.main(["compare", str(saved["jax"]), str(saved["port"]),
                         "--out", str(tmp_path / "cmp")])
    # the two packages' saves of the same chain: the same trajectory
    assert rep["per_robot_delta"]["inspector"]["rmse_raw_m"] < 1e-6
    kitti = tmp_path / "kitti"
    kitti.mkdir()
    for p in KITTI.iterdir():
        (kitti / p.name).symlink_to(p)
    assert tinspect.main([str(kitti), "--seq", "00"])["scans"] == 3
    assert (kitti / "inspection.json").exists()
    assert '"keyframes": 6' in capsys.readouterr().out


def test_stage_timer(tmp_path):
    t = profiling.StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["b"]["count"] == 1
    assert set(s["a"]) == {"count", "total_us", "avg_us", "max_us"}
    t.dump(tmp_path / "timing.txt")
    lines = (tmp_path / "timing.txt").read_text().splitlines()
    assert lines[0].startswith("a count 2 avg_us ") and " max_us " in lines[0]
    assert lines[1].startswith("b count 1 ")


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    x = torch.arange(64, dtype=torch.float32)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (x * 2).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::sum" in names
    assert any(e.key == "aten::mul" for e in prof.key_averages())
