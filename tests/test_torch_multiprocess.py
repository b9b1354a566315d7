"""Robots as separate processes (pipeline/multiprocess.py) and the
acceptance-set runner (pipeline/baseline_runs.main) of the port.

The two-process run is held to the JAX package's run of the same
arguments, read from tests/data/multiprocess_reference.json
(`python tools/multiprocess_reference.py --robots 2 --frames 48
--tick-every 12 --json tests/data/multiprocess_reference.json`); JAX
itself does not run here. 48 frames and a tick every 12 (the JAX
package's own test runs 60 and 15) keep the file under 30 s on the CPU.
The bands are the multi-robot ones of PERF.md §2: keyframes within 2,
remote keyframes merged at least one and within max(3, 0.3 ref), ATE at
most ref + 0.3 m (the deployment's run-to-run spread, ROADMAP §3 B4), an
inter-robot loop in the fleet, and fewer than 9000 bytes a merged
keyframe on the wire (the JAX package's tests/test_multiprocess.py).
Each robot takes two torch threads, so the two robots do not
oversubscribe a host that runs other test files beside them.

`baseline_runs.main` runs with its rows replaced by stubs, so no row
runs here: what is tested is its device handling, row 5's distributed
row beside the others (no "pending" entry is left) and the merge into an
existing file.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from mrg_slam_tpu_torch.pipeline import baseline_runs as bl
from mrg_slam_tpu_torch.pipeline import multiprocess as mp

REF = json.loads((Path(__file__).parent / "data"
                  / "multiprocess_reference.json").read_text())
ROBOTS, FRAMES, TICK = 2, 48, 12


def test_two_processes_land_in_the_bands_of_the_jax_run(tmp_path):
    results = mp.run_multiprocess(n_robots=ROBOTS, total_frames=FRAMES,
                                  tick_every=TICK, out_dir=str(tmp_path),
                                  device="cpu", cpu_threads=2)
    ref = REF[f"R{ROBOTS}_F{FRAMES}_T{TICK}"]
    assert set(results) == set(ref) == {"alpha", "bravo"}
    bad = []
    for name, r in results.items():
        want = ref[name]
        assert r["device"] == "cpu" and r["frames"] == want["frames"]
        if abs(r["keyframes"] - want["keyframes"]) > 2:
            bad.append(f"{name}: {r['keyframes']} keyframes, JAX "
                       f"{want['keyframes']}")
        rk, wk = r["remote_keyframes"], want["remote_keyframes"]
        if not (rk >= 1 and abs(rk - wk) <= max(3, 0.3 * wk)):
            bad.append(f"{name}: {rk} remote keyframes, JAX {wk}")
        if not r["ate_m"] <= want["ate_m"] + 0.3:
            bad.append(f"{name}: ATE {r['ate_m']:.3f} m, JAX "
                       f"{want['ate_m']:.3f}")
        per_kf = r["received_bytes"] / max(rk, 1)
        if not per_kf < 9000:
            bad.append(f"{name}: {per_kf:.0f} bytes a merged keyframe")
        # the CPU runs the plain versions: no kernel launched, no card
        assert r["launches"] == {"nn": 0, "moments": 0, "count": 0}
        assert r["peak_allocated_bytes"] is None
        assert r["publish_graph"] and all(
            p["keyframes"] >= 0 for p in r["publish_graph"])
        assert (tmp_path / f"{name}.tum").exists()
    assert sum(r["inter_robot_loops"] for r in results.values()) >= 1
    # what one robot sent is what the other received, in wire bytes
    assert (results["alpha"]["sent_bytes"]
            == results["bravo"]["received_bytes"])
    assert not bad, bad


def _stub(name):
    def row(n_frames=None, fused=False, device=None, **kw):
        row.calls.append(device)
        return {"config": name + ("_fused" if fused else ""),
                "ate_rmse": np.float32(0.125), "keyframes": 3,
                "keyframe_trajectory": np.zeros((3, 7), np.float32),
                "graphs": {"atlas": object()},
                "per_robot": {"atlas": np.arange(2)}}
    row.calls = []
    return row


ROWS = ("config1_odometry_only", "config2_full_slam",
        "config3_floor_augmented", "config4_two_robot",
        "config6_reversed_encounter", "config7_dynamic_world",
        "config5_distributed")


def test_baseline_main_writes_its_rows_and_keeps_the_file(tmp_path,
                                                          monkeypatch):
    stubs = {n: _stub(n) for n in ROWS}
    for n, fn in stubs.items():
        monkeypatch.setattr(bl, n, fn)
    out = tmp_path / "BASELINE_TORCH.json"
    out.write_text(json.dumps({"results_cuda": [{"config": "kept"}],
                               "other": 1, "pending": {"5": "old"}}))
    payload = bl.main(str(out), device="cpu")
    saved = json.loads(out.read_text())
    assert saved == payload
    # the row set (rows 1, 2, 3, 4, 6, 7, fused 1, 2 and row 5's
    # distributed row), on the CPU
    assert [r["config"] for r in saved["results"]] == [
        "config1_odometry_only", "config2_full_slam",
        "config3_floor_augmented", "config4_two_robot",
        "config6_reversed_encounter", "config7_dynamic_world",
        "config1_odometry_only_fused", "config2_full_slam_fused",
        "config5_distributed"]
    assert {r["device"] for r in saved["results"]} == {"cpu"}
    assert all(str(d) == "cpu" for fn in stubs.values() for d in fn.calls)
    row = saved["results"][0]
    assert row["ate_rmse"] == 0.125 and row["per_robot"] == {
        "atlas": [0, 1]}
    assert "graphs" not in row and "keyframe_trajectory" not in row
    # row 5's distributed half is a row now: no row is pending
    assert "pending" not in saved
    assert len(stubs["config5_distributed"].calls) == 1
    # other keys of the file stay; the card's rows are not touched
    assert saved["results_cuda"] == [{"config": "kept"}]
    assert saved["other"] == 1 and "card" not in saved
