"""The port's rosbag and KITTI readers and writers against the JAX
package's (mrg_slam_tpu/io/rosbag.py, mrg_slam_tpu/io/kitti.py,
mrg_slam_tpu/pipeline/bagfleet.py:23-45). Everything here is host numpy,
so every comparison is exact: the same decoded fields and points, the
same serialized bytes, a bag written by either package read back bit for
bit by the other, and the same KITTI arrays.
"""

import json
import sqlite3
from pathlib import Path

import numpy as np
import pytest

from mrg_slam_tpu.io import kitti as jkitti
from mrg_slam_tpu.io import rosbag as jbag
from mrg_slam_tpu.pipeline import bagfleet as jfleet

from mrg_slam_tpu_torch.io import kitti as tkitti
from mrg_slam_tpu_torch.io import rosbag as tbag
from mrg_slam_tpu_torch.pipeline import bagfleet as tfleet

DATA = Path(__file__).parent / "data"


def _clouds(rng, n, sizes=(100, 777)):
    """`n` (stamp, points) frames with ragged sizes, one of them empty,
    stamps with nanoseconds."""
    out = []
    for i in range(n):
        k = 0 if i == 2 else int(rng.integers(*sizes))
        out.append((1691500000.0 + i * 0.1 + 1e-9 * i,
                    (rng.normal(size=(k, 3)) * 20).astype(np.float32)))
    return out


def test_golden_cdr_decodes_as_the_jax_package():
    blob = (DATA / "golden_pointcloud2.bin").read_bytes()
    j, t = jbag.parse_pointcloud2(blob), tbag.parse_pointcloud2(blob)
    assert (t.stamp, t.frame_id, t.height, t.width, t.point_step,
            t.row_step, t.data) == (j.stamp, j.frame_id, j.height, j.width,
                                    j.point_step, j.row_step, j.data)
    assert ([(f.name, f.offset, f.datatype, f.count) for f in t.fields]
            == [(f.name, f.offset, f.datatype, f.count) for f in j.fields])
    xyz = t.xyz()
    np.testing.assert_array_equal(xyz, j.xyz())
    expect = json.loads((DATA / "golden_pointcloud2.json").read_text())
    np.testing.assert_array_equal(xyz, np.asarray(expect["xyz"],
                                                  np.float32))


def test_serialize_pointcloud2_is_byte_equal(rng):
    for stamp, pts in _clouds(rng, 4) + [(12.5, np.zeros((1, 3),
                                                         np.float32))]:
        for frame_id in ("velodyne", "husky1/os_sensor", ""):
            a = tbag.serialize_pointcloud2(stamp, frame_id, pts)
            assert a == jbag.serialize_pointcloud2(stamp, frame_id, pts)
            msg = tbag.parse_pointcloud2(a)
            assert msg.frame_id == frame_id
            np.testing.assert_array_equal(msg.xyz(), pts)


def _read_all(mod, path, topic):
    r = mod.BagReader(str(path))
    try:
        return r.topics(), list(r.messages(topic)), list(
            r.pointclouds(topic))
    finally:
        r.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_bag_reads_back_bit_for_bit_in_either_package(tmp_path, rng,
                                                        writer):
    clouds = _clouds(rng, 6)
    topic = "/husky1/velodyne_points"
    path = tmp_path / f"{writer}.db3"
    (tbag if writer == "port" else jbag).write_bag(str(path), topic, clouds)
    topics_t, msgs_t, pcs_t = _read_all(tbag, path, topic)
    topics_j, msgs_j, pcs_j = _read_all(jbag, path, topic)
    assert topics_t == topics_j == {topic: "sensor_msgs/msg/PointCloud2"}
    assert msgs_t == msgs_j
    assert len(pcs_t) == len(clouds)
    for (st, pt), (sj, pj), (s0, p0) in zip(pcs_t, pcs_j, clouds):
        assert st == sj and abs(st - s0) < 1e-6
        assert pt.tobytes() == pj.tobytes() == p0.tobytes()


def test_both_packages_write_the_same_rows(tmp_path, rng):
    topics = {"/atlas/velodyne_points": _clouds(rng, 5),
              "/bestla/velodyne_points": _clouds(rng, 4)}
    rows = []
    for mod, name in ((tbag, "t.db3"), (jbag, "j.db3")):
        mod.write_multi_bag(str(tmp_path / name), topics)
        conn = sqlite3.connect(str(tmp_path / name))
        try:
            rows.append((conn.execute("SELECT * FROM topics").fetchall(),
                         conn.execute("SELECT * FROM messages").fetchall()))
        finally:
            conn.close()
    assert rows[0] == rows[1]
    stamps = [ts for _, _, ts, _ in rows[0][1]]
    assert stamps == sorted(stamps)  # interleaved in time order


def test_read_fleet_frames_matches_the_jax_package(tmp_path, rng):
    a, b = _clouds(rng, 6), _clouds(rng, 5)
    bag = str(tmp_path / "fleet.db3")
    tbag.write_multi_bag(bag, {"/atlas/velodyne_points": a,
                               "/bestla/velodyne_points": b})
    for max_frames in (0, 3):
        got = tfleet.read_fleet_frames(bag, ["atlas", "bestla"],
                                       max_frames=max_frames)
        ref = jfleet.read_fleet_frames(bag, ["atlas", "bestla"],
                                       max_frames=max_frames)
        for name, src in (("atlas", a), ("bestla", b)):
            want = src[:max_frames] if max_frames else src
            assert len(got[name]) == len(ref[name]) == len(want)
            for (s1, p1), (s2, p2), (s3, p3) in zip(got[name], ref[name],
                                                    want):
                assert s1 == s2 and abs(s1 - s3) < 1e-6
                assert p1.tobytes() == p2.tobytes() == p3.tobytes()
    with pytest.raises(KeyError, match="charlie"):
        tfleet.read_fleet_frames(bag, ["charlie"])
    got = tfleet.read_fleet_frames(bag, ["atlas"],
                                   topic_template="/{robot}/velodyne_points")
    assert list(got) == ["atlas"]


def test_kitti_mini_arrays_equal_the_jax_package():
    t = tkitti.KittiSequence.open(str(DATA / "kitti_mini"), "00")
    j = jkitti.KittiSequence.open(str(DATA / "kitti_mini"), "00")
    assert len(t) == len(j) == 3
    assert t.velodyne_files == j.velodyne_files
    assert t.times.tobytes() == j.times.tobytes()
    assert t.gt_poses_velo.tobytes() == j.gt_poses_velo.tobytes()
    for i in range(len(t)):
        assert t.scan(i).tobytes() == j.scan(i).tobytes()
    seq = DATA / "kitti_mini" / "sequences" / "00"
    assert (tkitti.load_calib_velo_to_cam(seq / "calib.txt").tobytes()
            == jkitti.load_calib_velo_to_cam(seq / "calib.txt").tobytes())
    assert (tkitti.load_poses(DATA / "kitti_mini" / "poses" / "00.txt")
            .tobytes() == jkitti.load_poses(
                DATA / "kitti_mini" / "poses" / "00.txt").tobytes())


def test_kitti_without_poses_and_calib_without_tr(tmp_path):
    seq = tmp_path / "sequences" / "07"
    (seq / "velodyne").mkdir(parents=True)
    np.arange(8, dtype=np.float32).tofile(seq / "velodyne" / "000000.bin")
    (seq / "times.txt").write_text("0.0\n")
    s = tkitti.KittiSequence.open(str(tmp_path), "07")
    assert s.gt_poses_velo is None and len(s) == 1
    np.testing.assert_array_equal(s.scan(0), [[0, 1, 2], [4, 5, 6]])
    (seq / "calib.txt").write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    with pytest.raises(ValueError, match="no Tr line"):
        tkitti.load_calib_velo_to_cam(seq / "calib.txt")
