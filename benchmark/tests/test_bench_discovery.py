"""A new configuration, traffic mix and per-layer metric are found by
name in their folders, with no edit to a file that is there."""

import json
import types
import uuid
from pathlib import Path

import pytest

from benchmark import run, traffic

HERE = Path(run.__file__).resolve().parent


@pytest.fixture
def new_files():
    made = []

    def put(rel, text):
        p = HERE / rel
        p.write_text(text)
        made.append(p)
        return p

    yield put
    for p in made:
        p.unlink()


def test_new_files_are_found(new_files):
    tag = "t" + uuid.uuid4().hex[:8]
    cfg = json.loads((HERE / "configs" / "kitti_hdl64.json").read_text())
    cfg["name"] = tag
    new_files(f"configs/{tag}.json", json.dumps(cfg))
    mix = traffic.load_mix("explore")
    mix["episode_frames"] = 64
    new_files(f"traffic/{tag}.json", json.dumps(mix))
    new_files(f"metrics/{tag}.py", "UNIT = 'count'\n\n\ndef read(rec):\n"
                                   "    return float(rec.frames) * 2\n")
    assert run.load_config(tag)["name"] == tag
    assert traffic.load_mix(tag)["episode_frames"] == 64
    assert traffic.block_rows(traffic.load_mix(tag), 32).shape == (2, 32)
    m = run.reader(tag)
    assert m.UNIT == "count"
    assert m.read(types.SimpleNamespace(frames=21)) == 42.0


def test_metrics_are_chosen_per_cell_from_the_spec():
    spec = {"end_to_end": [{"name": "a"}, {"name": "b",
                                          "workloads": ["x.y"]}],
            "per_layer": [{"name": "c", "workloads": ["x.z"]},
                          {"name": "d"}]}
    assert [m["name"] for m in run.cell_metrics(spec, "x.y", False)] == [
        "a", "b"]
    assert [m["name"] for m in run.cell_metrics(spec, "x.y", True)] == ["d"]


def test_every_metric_of_the_spec_has_a_reader():
    spec = run.load_spec()
    for m in spec["per_layer"]:
        r = run.reader(m["name"])
        assert r.UNIT == m["unit"]
    for w in spec["workloads"]:
        assert run.load_config(w["config"])["name"] == w["config"]
        traffic.load_mix(w["traffic"])
