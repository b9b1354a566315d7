"""The port stands alone: no JAX, nothing of mrg_slam_tpu, and no silent
fall back to the CPU.

The import check runs in a subprocess because this test process has JAX
and mrg_slam_tpu loaded already (tests/conftest.py).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mrg_slam_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import chip_smoke  # its module-level imports
import mrg_slam_tpu_torch
# what a robot process's fresh interpreter imports (pipeline/multiprocess)
from mrg_slam_tpu_torch.pipeline.multiprocess import WORKER_IMPORT
exec(WORKER_IMPORT)
for m in pkgutil.walk_packages(mrg_slam_tpu_torch.__path__,
                               "mrg_slam_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "mrg_slam_tpu" or n.startswith("mrg_slam_tpu."))
print("LOADED", len([n for n in sys.modules
                     if n.startswith("mrg_slam_tpu_torch")]))
print("BAD", bad)
print("NAMES", sorted(n for n in sys.modules
                      if n.startswith("mrg_slam_tpu_torch")))
"""

# the back end's, the co-hosting's, the replay's, the floor and sensor
# processors', the exchange's, the launch path's and the run tooling's
# and robot processes' modules, which the walk above must reach
_BACK_END = ("config", "convert", "utils.se3np", "ops.registration",
             "ops.fitness", "graph.types", "graph.robust", "graph.edges",
             "graph.solve", "graph.builder", "models.keyframe",
             "models.keyframe_updater", "models.information_matrix",
             "models.graph_database", "models.pair_runner",
             "models.loop_detector", "parallel.messages", "models.backend",
             "io.pcd", "models.map_cloud", "models.shared_graph",
             "graph.chain_solver", "graph.chordal",
             "pipeline.baseline_runs", "models.odometry", "pipeline.replay",
             "utils.tum", "utils.geodesy", "utils.nmea", "ops.ransac",
             "ops.ground_fill", "models.floor_detection",
             "models.processors", "models.coordinator",
             "pipeline.multirobot_split", "io.rosbag", "io.kitti",
             "models.persistence", "models.markers", "pipeline.bagfleet",
             "launch", "utils.profiling", "pipeline.tools",
             "pipeline.inspect", "parallel.channel",
             "pipeline.multiprocess", "ops.gaussian_voxel",
             "parallel.dist_solver", "parallel.dryrun")


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    loaded = int(re.search(r"LOADED (\d+)", out.stdout).group(1))
    assert loaded >= 71  # every module of the package was imported
    names = out.stdout.split("NAMES", 1)[1]
    for m in _BACK_END:
        assert f"'mrg_slam_tpu_torch.{m}'" in names, m


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|mrg_slam_tpu)(?![\w])", re.M)


def test_port_sources_name_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 72
    for m in _BACK_END:
        assert PORT / (m.replace(".", "/") + ".py") in files, m
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not hits, hits
    # the check itself: a JAX-package import is caught, the port's is not
    assert _IMPORT.search("from mrg_slam_tpu.ops import knn")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("from mrg_slam_tpu_torch.ops import knn")


def test_dist_solver_alone_imports_neither_jax_nor_the_jax_package():
    """What a rank's fresh interpreter imports (parallel/dist_solver.py
    and the dry run) loads neither JAX nor the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
             "import mrg_slam_tpu_torch.parallel.dist_solver, "
             "mrg_slam_tpu_torch.parallel.dryrun; "
             "print(sorted(n for n in sys.modules if n.split('.')[0] in "
             "('jax', 'jaxlib', 'mrg_slam_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_refuse_a_missing_card(tmp_path):
    """Without device=..., an entry point wants the card and raises when
    there is none, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from mrg_slam_tpu_torch.convert import carry_from_numpy
    from mrg_slam_tpu_torch.models.odometry_fused import init_carry
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.runtime import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_carry(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        PointCloud.from_array(np.zeros((4, 3), np.float32))
    carry = {k: np.asarray(v) for k, v in
             init_carry(16, device="cpu")._asdict().items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        carry_from_numpy(carry)
    assert resolve_device("cpu").type == "cpu"
    # the command line wants the card too unless --device says otherwise,
    # and raises before it reads a dataset
    from mrg_slam_tpu_torch import launch

    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--dataset", "kitti", "--kitti-root",
                     str(ROOT / "tests" / "data" / "kitti_mini"),
                     "--output", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--dataset", "rosbag", "--bag",
                     str(tmp_path / "no_such.db3"), "--robots", "a,b",
                     "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    # robot processes and the acceptance-set runner: they raise before
    # they spawn a worker, run a row or write a file
    from mrg_slam_tpu_torch.pipeline import baseline_runs, multiprocess

    with pytest.raises(RuntimeError, match="CUDA"):
        multiprocess.run_multiprocess(out_dir=str(tmp_path / "mp"))
    with pytest.raises(RuntimeError, match="CUDA"):
        multiprocess.main(["--robots", "2", "--out", str(tmp_path / "mp")])
    assert not (tmp_path / "mp").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        baseline_runs.main(str(tmp_path / "BASELINE_TORCH.json"))
    assert not (tmp_path / "BASELINE_TORCH.json").exists()
    # the distributed solve: no rank is spawned without a card, and nccl
    # never serves two ranks on one card or the CPU
    from mrg_slam_tpu_torch.parallel import dist_solver, dryrun

    with pytest.raises(RuntimeError, match="CUDA"):
        baseline_runs.config5_distributed()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dist_solver.run_ranks(dist_solver.solve_graphs, 2, args=([],))
    with pytest.raises(ValueError, match="nccl"):
        dist_solver.run_ranks(dist_solver.solve_graphs, 2, "cpu",
                              args=([],), backend="nccl")
    with pytest.raises(ValueError, match="one card a rank"):
        dist_solver.group_backend(torch.device("cuda"), 2, "nccl")


def test_worker_bootstrap_imports_the_port_only():
    """The robot process's bootstrap names the port's module and sets no
    JAX variable of its own."""
    from mrg_slam_tpu_torch.pipeline import multiprocess

    assert multiprocess.WORKER_IMPORT in multiprocess.BOOTSTRAP
    assert not _IMPORT.search(multiprocess.BOOTSTRAP.replace("; ", "\n"))
    env = multiprocess._worker_env()
    assert str(ROOT) in env["PYTHONPATH"].split(os.pathsep)
    assert {k for k in env if k.startswith("JAX")} == {
        k for k in os.environ if k.startswith("JAX")}


def test_runtime_pins_full_float32():
    from mrg_slam_tpu_torch.runtime import resolve_device

    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.are_deterministic_algorithms_enabled()


def test_config_from_fields_round_trips_the_jax_configs():
    import dataclasses

    from mrg_slam_tpu import config as jconfig

    from mrg_slam_tpu_torch import config as tconfig
    from mrg_slam_tpu_torch.convert import config_from_fields

    for name in ("PrefilterConfig", "RegistrationConfig",
                 "ScanMatchingOdometryConfig"):
        jc = getattr(jconfig, name)()
        tc = config_from_fields(dataclasses.asdict(jc))
        assert type(tc) is getattr(tconfig, name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    with pytest.raises(ValueError):
        config_from_fields({"not_a_field": 1})
