"""Graph persistence, the loaded and static-keyframe flushes, the .g2o
import and the markers of the port against the JAX package's
(mrg_slam_tpu/models/persistence.py, models/graph_database.py:148-150,
282-298, 365-450, models/markers.py).

Both packages build the same small graph from the same numpy inputs: a
six-keyframe chain with constant information, Huber(0.7) odometry edges,
sensor attachments on two keyframes, a loop edge and a GPS origin, ticked
once. Tolerances and why:
- A save -> load -> flush (no optimize) -> save repeats `keyframes/` and
  `edges/` byte for byte, within the port and across the packages in
  both directions: the estimates are float32 written with %.9f and read
  back as float32 on both sides, and the clouds go through the same PCD
  bytes. A directory loaded and saved again by each package gives the
  same graph.g2o, kernels sidecar and special_nodes.csv too.
- `load_g2o` is exact: the same parsing into the same builder tables.
- The first tick of a loaded graph (estimates perturbed before loading)
  runs LM in two float32 libraries: chi2 within 1e-3 relative and poses
  within 1.0 m, the ROADMAP's solve bounds (equal-chi2 valleys).
- `graph_summary` and `export_ply` on a loaded, unoptimized graph see the
  same estimates, so node positions and PLY points are exact; the
  ellipsoids come from each package's float32 dense inverse, so the
  covariances they rebuild agree within 1e-4 of the largest entry.
"""

import dataclasses
import filecmp
from pathlib import Path

import numpy as np
import pytest

from mrg_slam_tpu import config as jconfig
from mrg_slam_tpu.models import markers as jmarkers
from mrg_slam_tpu.models import persistence as jpersist
from mrg_slam_tpu.models.backend import MrgSlam as JMrgSlam
from mrg_slam_tpu.models.graph_database import Loop as JLoop
from mrg_slam_tpu.models.keyframe import KeyFrame as JKeyFrame
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud

from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.models import markers as tmarkers
from mrg_slam_tpu_torch.models import persistence as tpersist
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.models.graph_database import Loop
from mrg_slam_tpu_torch.models.keyframe import KeyFrame
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.utils import se3np

CAP = 256
N_KF = 6


def _jcfg(name):
    reg = jconfig.RegistrationConfig(reg_transformation_epsilon=1e-3,
                                     reg_maximum_iterations=16,
                                     reg_correspondence_randomness=10)
    return jconfig.SlamConfig(
        own_name=name, multi_robot_names=(name,),
        keyframe_delta_trans=0.5, capacity_keyframes=32, capacity_edges=128,
        capacity_keyframe_points=CAP, registration=reg,
        optimizer=jconfig.OptimizerConfig(solver_backend="dense",
                                          g2o_solver_num_iterations=16,
                                          per_tick_marginals="exact"),
        inf_matrix=jconfig.InformationMatrixConfig(use_const_inf_matrix=True),
        loop=dataclasses.replace(jconfig.LoopClosureConfig(),
                                 capacity_candidates=2,
                                 candidate_max_xy_distance=0.0),
        odometry_edge_robust_kernel="Huber",
        odometry_edge_robust_kernel_size=0.7,
        robot_remove_points_radius=0.0)


def _slam(side, name):
    if side == "jax":
        return JMrgSlam(_jcfg(name))
    return MrgSlam(config_from_fields(dataclasses.asdict(_jcfg(name))),
                   device="cpu")


def _cloud(side, pts):
    if side == "jax":
        return JCloud.from_array(pts, capacity=CAP)
    return PointCloud.from_array(pts, capacity=CAP, device="cpu")


def _run(side, seed=11):
    """The chain of the module docstring on `side`."""
    rng = np.random.default_rng(seed)
    slam = _slam(side, "saver")
    kfs = []
    for i in range(N_KF):
        pts = rng.uniform(-2, 2, size=(64 + 8 * i, 3)).astype(np.float32)
        yaw = 0.05 * i
        odom = np.asarray([i * 1.0, 0.1 * i * i, 0.0, np.cos(yaw / 2), 0.0,
                           0.0, np.sin(yaw / 2)], np.float32)
        kf = slam.db.add_odom_keyframe(float(i) + 0.25, odom,
                                       accum_distance=float(i),
                                       cloud=_cloud(side, pts))
        if i == 1:
            kf.floor_coeffs = np.asarray([0, 0, 1, -0.2], np.float32)
            kf.utm_coord = np.asarray([453000.1, 5428000.5, 110.25],
                                      np.float32)
        if i == 2:
            kf.acceleration = np.asarray([0.1, 0.0, 9.81], np.float32)
            kf.orientation = se3np.rpy_to_quat(0.0, 0.05, 0.2)
        kfs.append(kf)
    slam.gps_processor.zero_utm = np.asarray([453000.0, 5428000.0, 110.0])
    slam.optimization_tick(now=float(N_KF))
    rel = se3np.pose_between(kfs[5].odom, kfs[1].odom)
    rel[:3] += np.asarray([0.03, -0.02, 0.01], np.float32)
    loop_cls = JLoop if side == "jax" else Loop
    slam.db.insert_loops([loop_cls(key1=kfs[5], key2=kfs[1],
                                   relative_pose=rel, fitness=0.05)])
    return slam


def _persist(side):
    return jpersist if side == "jax" else tpersist


def _load_flush_save(side, src, dst, name="loader"):
    slam = _slam(side, name)
    n = _persist(side).load_graph(slam, src)
    slam.db.flush_loaded_graph(slam.loop_detector.loop_manager)
    _persist(side).save_graph(slam, dst)
    return slam, n


def _same_tree(a: Path, b: Path, subs=("keyframes", "edges")):
    for sub in subs:
        names = sorted(p.name for p in (a / sub).iterdir())
        assert names == sorted(p.name for p in (b / sub).iterdir())
        for name in names:
            files = sorted(p.name for p in (a / sub / name).iterdir())
            assert files == sorted(p.name for p in (b / sub / name).iterdir())
            for f in files:
                assert filecmp.cmp(a / sub / name / f, b / sub / name / f,
                                   shallow=False), f"{sub}/{name}/{f}"


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The chain saved by each package: {side: (slam, directory)}."""
    root = tmp_path_factory.mktemp("saved")
    out = {}
    for side in ("jax", "port"):
        slam = _run(side)
        n = _persist(side).save_graph(slam, root / side)
        assert n == N_KF
        out[side] = (slam, root / side)
    return out


def test_port_roundtrip_is_byte_identical(saved, tmp_path):
    _, d1 = saved["port"]
    slam2, n = _load_flush_save("port", d1, tmp_path / "again")
    assert n == N_KF
    _same_tree(d1, tmp_path / "again")
    # the loaded loop is registered with the loop manager
    loaded = {k.uuid: k for k in slam2.db.new_keyframes}
    loop = [e for e in slam2.db.edges if e.type == "loop"]
    assert len(loop) == 1
    kf5 = loaded[loop[0].from_uuid]
    got = slam2.loop_detector.loop_manager.get_loop(kf5.slam_uuid,
                                                    kf5.slam_uuid)
    assert got is not None and got.key1 is kf5


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_roundtrip_across_packages_is_byte_identical(saved, tmp_path,
                                                     writer, reader):
    _, d1 = saved[writer]
    _load_flush_save(reader, d1, tmp_path / "read")
    _same_tree(d1, tmp_path / "read")
    # the same directory loaded and saved by each package: the same graph
    # in every file but the timings
    _load_flush_save(writer, d1, tmp_path / "same")
    _same_tree(tmp_path / "read", tmp_path / "same")
    for f in ("graph.g2o", "graph.g2o.kernels", "special_nodes.csv",
              "network_stats.txt"):
        assert filecmp.cmp(tmp_path / "read" / f, tmp_path / "same" / f,
                           shallow=False), f


def test_save_writes_what_the_jax_package_writes(saved):
    (_, dj), (_, dt) = saved["jax"], saved["port"]
    for f in ("special_nodes.csv", "network_stats.txt", "zero_utm.txt",
              "graph.g2o.kernels"):
        assert (dj / f).read_text() == (dt / f).read_text(), f
    # the same data.txt keys in the same order; clouds byte for byte
    for sub in ("keyframes", "edges"):
        for name in sorted(p.name for p in (dj / sub).iterdir()):
            keys = [[line.split()[0] for line in
                     (d / sub / name / "data.txt").read_text().splitlines()]
                    for d in (dj, dt)]
            assert keys[0] == keys[1]
            if sub == "keyframes":
                assert filecmp.cmp(dj / sub / name / "cloud.pcd",
                                   dt / sub / name / "cloud.pcd",
                                   shallow=False)
    assert ((dt / "timing_stats.txt").read_text().split()[:4]
            == (dj / "timing_stats.txt").read_text().split()[:4])


def test_attachments_kernels_anchor_and_uuid_dedup(saved):
    _, d = saved["port"]
    slam = _slam("port", "loader")
    assert tpersist.load_graph(slam, d) == N_KF
    assert slam.db.flush_loaded_graph(slam.loop_detector.loop_manager)
    assert not slam.db.flush_loaded_graph()
    kfs = sorted(slam.db.new_keyframes, key=lambda k: k.stamp)
    np.testing.assert_array_equal(kfs[1].floor_coeffs,
                                  np.float32([0, 0, 1, -0.2]))
    np.testing.assert_allclose(kfs[1].utm_coord,
                               [453000.1, 5428000.5, 110.25], rtol=1e-6)
    assert kfs[2].acceleration is not None and kfs[2].orientation is not None
    assert kfs[3].floor_coeffs is None and kfs[3].utm_coord is None
    # nodes at the saved estimates, clouds on the store's device
    db = slam.db
    for k in kfs:
        np.testing.assert_array_equal(db.graph.poses[k.node_id],
                                      k.estimate_loaded)
        assert k.cloud.points.device == db.graph.device
        assert k.cloud.capacity == CAP
    odom = [e for e in db.edges if e.type == "odom"]
    assert len(odom) == N_KF - 1 and all(
        e.robust_kernel == "Huber" and abs(e.robust_kernel_size - 0.7) < 1e-9
        for e in odom)
    # prev edges wired from the chain's third keyframe on, next edges all
    assert [k.prev_edge is not None for k in kfs] == [False, False] + [
        True] * (N_KF - 2)
    assert [k.next_edge is not None for k in kfs] == [True] * (N_KF - 1) + [
        False]
    # the anchor edge re-attached to this store's own anchor, made fixed
    # at identity; the loaded anchor uuid is an alias of it
    anchor = [e for e in db.edges if e.type == "anchor"]
    assert len(anchor) == 1 and db.anchor_kf is not None
    assert db.graph.fixed[db.anchor_kf.node_id]
    np.testing.assert_array_equal(db.graph.poses[db.anchor_kf.node_id],
                                  se3np.pose_identity())
    assert db.uuid_keyframe_map[anchor[0].from_uuid] is db.anchor_kf
    assert db.anchor_kf.uuid != anchor[0].from_uuid
    # uuid dedup: loading again queues nothing, a tick merges nothing
    nodes, edges = db.graph.num_nodes, db.graph.num_edges
    assert tpersist.load_graph(slam, d) == 0
    assert not db.loaded_graph_queue
    slam.optimization_tick(now=1.0)
    assert (db.graph.num_nodes, db.graph.num_edges) == (nodes, edges)
    assert len(db.keyframes) + len(db.new_keyframes) == N_KF
    # special_nodes.csv names this store's anchor node after a save
    assert "floor_node,-1" in (d / "special_nodes.csv").read_text()


def test_special_nodes_floor_id(tmp_path):
    slam = _run("port")
    slam.floor_processor.plane_node_id = slam.db.graph.add_plane_node(
        [0, 0, 1, 0], fixed=True)
    tpersist.save_graph(slam, tmp_path / "g")
    rows = dict(line.split(",") for line in
                (tmp_path / "g" / "special_nodes.csv").read_text()
                .splitlines())
    assert int(rows["floor_node"]) == slam.floor_processor.plane_node_id
    assert int(rows["anchor_node"]) == slam.db.anchor_kf.node_id >= 0
    assert int(rows["anchor_edge"]) == slam.db.anchor_edge.edge_id >= 0


def _static_kfs(side, n=2):
    out = []
    for i in range(n):
        pts = np.random.default_rng(40 + i).uniform(-1, 1, (32, 3))
        cls = JKeyFrame if side == "jax" else KeyFrame
        out.append(cls(robot_name="map_server", stamp=100.0 + i,
                       odom=np.asarray([5.0 + i, 2.0, 0, 1, 0, 0, 0],
                                       np.float32),
                       accum_distance=-1.0, cloud=_cloud(side, pts)))
    return out


@pytest.mark.parametrize("side", ["jax", "port"])
def test_static_keyframes_are_fixed_and_graduate(saved, tmp_path, side):
    slam = saved[side][0]  # its directory is written already
    db = slam.db
    statics = _static_kfs(side)
    db.add_static_keyframes(statics)
    assert db.flush_static_keyframe_queue()
    assert not db.flush_static_keyframe_queue()
    for k in statics:
        assert k.static_keyframe and db.graph.fixed[k.node_id]
        np.testing.assert_array_equal(db.graph.poses[k.node_id], k.odom)
        assert k in db.new_keyframes
    slam.optimization_tick(now=10.0)
    assert all(k in db.keyframes for k in statics)
    _persist(side).save_graph(slam, tmp_path / "g")
    # loaded into a fresh store: fixed nodes that graduate at once
    slam2 = _slam("port", "loader")
    assert tpersist.load_graph(slam2, tmp_path / "g") == N_KF + 2
    slam2.db.flush_loaded_graph(slam2.loop_detector.loop_manager)
    loaded = [k for k in slam2.db.keyframes if k.static_keyframe]
    assert len(loaded) == 2 and all(
        slam2.db.graph.fixed[k.node_id] for k in loaded)
    assert not any(k.static_keyframe for k in slam2.db.new_keyframes)


def test_load_g2o_matches_the_jax_package(saved):
    _, d = saved["jax"]
    gj = jpersist.load_g2o(d / "graph.g2o", d / "graph.g2o.kernels")
    gt = tpersist.load_g2o(d / "graph.g2o", d / "graph.g2o.kernels",
                           device="cpu")
    assert (gt.num_nodes, gt.num_edges) == (gj.num_nodes, gj.num_edges)
    assert gt.num_nodes == N_KF + 1 and gt.num_edges == N_KF + 1
    np.testing.assert_array_equal(gt.poses, gj.poses)
    np.testing.assert_array_equal(gt.fixed, gj.fixed)
    assert gt.fixed.sum() == 1
    for key in ("from_idx", "to_idx", "meas", "info", "kernel", "delta"):
        np.testing.assert_array_equal(gt._se3.arrays[key][:gt.num_edges],
                                      gj._se3.arrays[key][:gj.num_edges])
    # without the sidecar every edge is plain
    g0 = tpersist.load_g2o(d / "graph.g2o", device="cpu")
    assert not g0._se3.arrays["kernel"][:g0.num_edges].any()


def _perturbed(src: Path, dst: Path) -> Path:
    """A copy of a saved graph with every estimate moved (the first tick
    then has something to solve)."""
    import shutil

    shutil.copytree(src, dst)
    rng = np.random.default_rng(7)
    for kdir in sorted((dst / "keyframes").iterdir()):
        lines = (kdir / "data.txt").read_text().splitlines()
        for i, line in enumerate(lines):
            if line.startswith("estimate "):
                v = np.asarray([float(x) for x in line.split()[1:]])
                v[:3] += rng.normal(scale=0.2, size=3)
                lines[i] = "estimate " + " ".join(f"{x:.9f}" for x in v)
        (kdir / "data.txt").write_text("\n".join(lines) + "\n")
    return dst


def test_first_tick_of_a_loaded_graph_matches_the_jax_package(saved,
                                                              tmp_path):
    d = _perturbed(saved["jax"][1], tmp_path / "moved")
    out = {}
    for side in ("jax", "port"):
        slam = _slam(side, "loader")
        _persist(side).load_graph(slam, d)
        stats = slam.optimization_tick(now=0.0)
        assert stats is not None
        g = slam.db.graph
        assert g.chi2_initial > 10 * g.chi2_final
        ids = [k.node_id for k in sorted(slam.db.keyframes,
                                         key=lambda k: k.stamp)]
        out[side] = (g.chi2_final, g.poses[ids], stats.num_loops)
    (cj, pj, lj), (ct, pt, lt) = out["jax"], out["port"]
    assert abs(ct - cj) <= 1e-3 * max(cj, 1e-9), (ct, cj)
    assert np.abs(pt[:, :3] - pj[:, :3]).max() < 1.0
    assert lt == lj == 0


def test_markers_match_the_jax_package(saved, tmp_path):
    _, d = saved["jax"]
    sj, _ = _load_flush_save("jax", d, tmp_path / "j")
    st, _ = _load_flush_save("port", d, tmp_path / "t")
    mj = jmarkers.graph_summary(sj, with_marginals=True)
    mt = tmarkers.graph_summary(st, with_marginals=True)
    assert mt["robot"] == mj["robot"] == "loader"
    assert mt["nodes"] == mj["nodes"]
    assert mt["edges"] == mj["edges"]
    assert mt.get("loop_radius_circle") == mj.get("loop_radius_circle")
    assert len(mt["ellipsoids"]) == len(mj["ellipsoids"]) == N_KF

    def rebuilt(e):
        r, a = np.asarray(e["rotation"]), np.asarray(e["axes"])
        return r @ np.diag(a ** 2) @ r.T

    for ej, et in zip(mj["ellipsoids"], mt["ellipsoids"]):
        cj, ct = rebuilt(ej), rebuilt(et)
        assert np.abs(ct - cj).max() <= 1e-4 * np.abs(cj).max()
    # the PLY: the same header and colours, the same points
    jmarkers.export_ply(sj, tmp_path / "j.ply")
    tmarkers.export_ply(st, tmp_path / "t.ply")
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply"
                                                 ).read_bytes()
    # per-tick marginals are used when a tick left them
    st.optimization_tick(now=1.0)
    assert st.db.graph.last_marginals is not None
    m2 = tmarkers.graph_summary(st, with_marginals=True)
    assert len(m2["ellipsoids"]) == N_KF
