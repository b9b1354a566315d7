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
# processors' and the exchange's modules, which the walk above must reach
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
             "pipeline.multirobot_split")


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    loaded = int(re.search(r"LOADED (\d+)", out.stdout).group(1))
    assert loaded >= 57  # every module of the package was imported
    names = out.stdout.split("NAMES", 1)[1]
    for m in _BACK_END:
        assert f"'mrg_slam_tpu_torch.{m}'" in names, m


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|mrg_slam_tpu)(?![\w])", re.M)


def test_port_sources_name_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 58
    for m in _BACK_END:
        assert PORT / (m.replace(".", "/") + ".py") in files, m
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not hits, hits
    # the check itself: a JAX-package import is caught, the port's is not
    assert _IMPORT.search("from mrg_slam_tpu.ops import knn")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("from mrg_slam_tpu_torch.ops import knn")


def test_entry_points_refuse_a_missing_card():
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
