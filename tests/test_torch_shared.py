"""The port's shared-graph co-hosting (`SharedGraphSlam`) against the JAX
package's and against the port's `MrgSlam`, on the same numpy inputs:
keyframes, loops, solves, other-robot point removal at the default
radius, the joint map and `save_map`. The multi-chain store, point
removal alone and the map generator are held to the JAX package's in
tests/test_torch_multirobot.py.

Inputs: the small world of tests/test_torch_backend.py (1.2 laps of a
12 m circle, 256-lane clouds and their GICP covariances). Two robots
survey overlapping arcs of it: alpha frames 0-35, bravo frames 30-65,
each with its own seeded odometry drift from its own start, and start
poses at the truth of their first frames, as bench.py's
run_multirobot_scaling places its robots.

Tolerances and why:
- One robot: `SharedGraphSlam` with one robot equals `MrgSlam` bit for
  bit (the same store, pair program and LM on the same inputs), and so
  do their maps; `save_map`'s file reads back bit for bit through both
  packages' `load_pcd`.
- Two robots against the JAX package's `SharedGraphSlam`, with its pair
  buckets padded to 128 rows as tests/test_torch_slice.py pads them: the
  same keyframes, the same loop pairs by (robot, stamp), inter-robot
  loops among them, chi2 per tick within rel 1e-3 (absolute floor 1e-6
  for the loop-free ticks, whose chi2 is float32 rounding noise) and
  both trajectories within 1e-2 m: the tolerances of
  tests/test_torch_slice.py, for the same reasons.
- Point removal at the default radius: the same mask as the JAX
  package's.
- The joint map: as tests/test_torch_multirobot.py holds the map
  generator (the same voxel count, points within 1e-5 m).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.io.pcd import load_pcd as jload_pcd
from mrg_slam_tpu.models.shared_graph import SharedGraphSlam as JShared
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud

from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.io.pcd import load_pcd
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.models.map_cloud import MapCloudGenerator
from mrg_slam_tpu_torch.models.shared_graph import SharedGraphSlam
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.utils import se3np

from test_torch_backend import CAP, make_world
from test_torch_multirobot import _same_map
from test_torch_slice import JSLAM_NO_MARGINALS

NAMES = ("alpha", "bravo")
WINDOWS = {"alpha": (0, 36), "bravo": (30, 66)}
TICK_EVERY = 20


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: these tensors are small, and the suite's worker
    processes already share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return make_world()


def _jcfg(names, **change):
    """tests/test_torch_slice.py's config with bench.py's multi-robot loop
    settings (2 candidates, a 2 m gap between inter-robot loops)."""
    loop = dataclasses.replace(JSLAM_NO_MARGINALS.loop, capacity_candidates=2,
                               accum_distance_thresh_other_robot=2.0)
    return dataclasses.replace(JSLAM_NO_MARGINALS, own_name=names[0],
                               multi_robot_names=tuple(names), loop=loop,
                               **change)


def _tcfg(names, **change):
    return config_from_fields(dataclasses.asdict(_jcfg(names, **change)))


def _tcloud(p, m):
    return PointCloud(torch.from_numpy(p), torch.from_numpy(m))


def _jcloud(p, m):
    return JCloud(jnp.asarray(p), jnp.asarray(m))


def _init_pose(p):
    yaw = 2.0 * np.arctan2(p[6], p[3])
    return (float(p[0]), float(p[1]), float(p[2]), float(yaw), 0.0, 0.0)


def _odometry(traj, frames, seed):
    """The truth of `frames` relative to the first of them, with a seeded
    drift (tests/test_torch_backend.py's model)."""
    rng = np.random.default_rng(seed)
    start_inv = se3np.pose_inverse(traj[frames[0]])
    drift = se3np.pose_identity()
    out = []
    for k, i in enumerate(frames):
        step = np.concatenate([rng.normal(0, 0.01, 3), [1.0],
                               rng.normal(0, 0.002, 3)]).astype(np.float32)
        step[3:] /= np.linalg.norm(step[3:])
        if k:
            drift = se3np.pose_compose(drift, step)
        out.append(se3np.pose_compose(se3np.pose_compose(start_inv,
                                                         traj[i]), drift))
    return out


def _drive(group, world, names, cloud, covs):
    """Interleaved robots, one tick every TICK_EVERY frames and a last
    one -> chi2 (before, after) per tick."""
    odo = {n: _odometry(world["traj"], range(*WINDOWS[n]), seed=11 + k)
           for k, n in enumerate(names)}
    n_local = max(hi - lo for lo, hi in WINDOWS.values())
    chi2 = []
    for i in range(n_local):
        for n in names:
            lo, hi = WINDOWS[n]
            if lo + i >= hi:
                continue
            group.process_scan(n, i * 0.1, odo[n][i],
                               cloud(*world["clouds"][lo + i]),
                               source_covs=covs(world["covs"][lo + i]))
        if (i + 1) % TICK_EVERY == 0:
            st = group.optimization_tick(now=i * 0.1)
            chi2.append((st.chi2_before, st.chi2_after))
    st = group.optimization_tick(now=n_local * 0.1)
    if st is not None:
        chi2.append((st.chi2_before, st.chi2_after))
    return np.asarray(chi2)


def _loops(db):
    kfs = db.uuid_keyframe_map

    def key(kf):
        return kf.robot_name, round(kf.stamp, 3)

    return sorted((key(kfs[e.from_uuid]), key(kfs[e.to_uuid]))
                  for e in db.edges if e.type == "loop")


def _keyframes(db):
    return sorted((k.robot_name, round(k.stamp, 3))
                  for k in db.keyframes + db.new_keyframes)


@pytest.fixture(scope="module")
def one_robot(world):
    """MrgSlam and SharedGraphSlam with one robot, driven alike over
    frames 0-9 and then 56-65, which revisit them (a tick after each
    half) -> (classic, shared, odometry, per-tick stats pairs)."""
    cfg = _tcfg(("alpha",))
    frames = list(range(0, 10)) + list(range(56, 66))
    odo = _odometry(world["traj"], frames, seed=11)
    classic = MrgSlam(cfg, device="cpu")
    shared = SharedGraphSlam(cfg, ["alpha"], device="cpu")
    ticks = []
    for i, f in enumerate(frames):
        args = (i * 0.1, odo[i], _tcloud(*world["clouds"][f]))
        covs = torch.from_numpy(world["covs"][f])
        classic.process_scan(*args, source_covs=covs)
        shared.process_scan("alpha", *args, source_covs=covs)
        if (i + 1) % 10 == 0:
            ticks.append((classic.optimization_tick(now=i * 0.1),
                          shared.optimization_tick(now=i * 0.1)))
    return classic, shared, odo, ticks


def test_one_robot_equals_mrgslam(one_robot):
    """SharedGraphSlam with one robot is MrgSlam, bit for bit; so are
    their slam pose broadcasts and maps."""
    classic, shared, odo, ticks = one_robot
    for a, b in ticks:
        assert (a.chi2_before, a.chi2_after, a.iterations, a.num_loops,
                a.pair_buckets) == (b.chi2_before, b.chi2_after,
                                    b.iterations, b.num_loops,
                                    b.pair_buckets)
    a, b = classic.trajectory(), shared.trajectory("alpha")
    assert a.shape == b.shape and len(a) >= 8
    assert ticks[-1][0].num_loops > 0
    assert (a.view(np.uint32) == b.view(np.uint32)).all()
    assert _loops(classic.db) == _loops(shared.db)
    assert [e.type for e in classic.db.edges] == \
        [e.type for e in shared.db.edges]
    pa = classic.slam_pose_broadcast(9.0)
    pb = shared.slam_pose_broadcast("alpha", 9.0)
    assert (pa.pose == pb.pose).all() and pa.accum_dist == pb.accum_dist
    np.testing.assert_array_equal(classic.map_pose(odo[-1]),
                                  shared.map_pose("alpha", odo[-1]))
    np.testing.assert_array_equal(classic.generate_map(),
                                  shared.generate_map())


def test_save_map_reads_back_through_both_packages(one_robot, tmp_path):
    classic = one_robot[0]
    empty = MrgSlam(classic.cfg, device="cpu")
    assert empty.save_map(str(tmp_path / "none.pcd")) == 0
    assert not (tmp_path / "none.pcd").exists()
    path = tmp_path / "map.pcd"
    n = classic.save_map(str(path), resolution=0.5)
    pts = load_pcd(path)
    assert n == len(pts) > 100
    np.testing.assert_array_equal(jload_pcd(path), pts)
    want = MapCloudGenerator(0.5, classic.cfg.map_cloud_min_points_per_voxel,
                             classic.cfg.map_cloud_distance_far_thresh
                             ).from_store(classic.db)
    np.testing.assert_array_equal(pts, want)


@pytest.fixture(scope="module")
def two_robots(world):
    jgroup = JShared(_jcfg(NAMES), list(NAMES),
                     {n: _init_pose(world["traj"][lo])
                      for n, (lo, _) in WINDOWS.items()})
    runner = jgroup.loop_detector.runner
    runner.MIN_BUCKET = 128  # one pair program for every tick
    jchi2 = _drive(jgroup, world, NAMES, _jcloud, jnp.asarray)
    group = SharedGraphSlam(_tcfg(NAMES), list(NAMES),
                            {n: _init_pose(world["traj"][lo])
                             for n, (lo, _) in WINDOWS.items()},
                            device="cpu")
    chi2 = _drive(group, world, NAMES, _tcloud, torch.from_numpy)
    return jgroup, jchi2, group, chi2


def test_two_robots_match_jax(two_robots):
    jgroup, jchi2, group, chi2 = two_robots
    assert _keyframes(group.db) == _keyframes(jgroup.db)
    loops = _loops(group.db)
    inter = [p for p in loops if p[0][0] != p[1][0]]
    assert inter, "no inter-robot loop"
    assert loops == _loops(jgroup.db)
    np.testing.assert_allclose(chi2, jchi2, rtol=1e-3, atol=1e-6)
    for name in NAMES:
        t, jt = group.trajectory(name), jgroup.trajectory(name)
        assert t.shape == jt.shape and len(t) >= 10
        assert np.abs(t[:, :3] - jt[:, :3]).max() < 1e-2
        np.testing.assert_allclose(group.views[name].trans_odom2map,
                                   jgroup.views[name].trans_odom2map,
                                   rtol=0, atol=1e-2)
    # one anchor per robot, each robot's own slam_uuid on its keyframes
    assert sum(e.type == "anchor" for e in group.db.edges) == 2
    for name in NAMES:
        assert {k.slam_uuid for k in group.robot_keyframes(name)} == \
            {group.views[name].slam_uuid}
    assert len({v.slam_uuid for v in group.views.values()}) == 2


def test_joint_map_matches_jax(two_robots):
    """generate_map over both robots' keyframes, at the JAX package's
    estimates on both sides (so that only map assembly is compared)."""
    jgroup, _, group, _ = two_robots
    jpose = {(k.robot_name, round(k.stamp, 3)): k.estimate(jgroup.db.graph)
             for k in jgroup.db.keyframes + jgroup.db.new_keyframes}
    kfs = group.db.keyframes + group.db.new_keyframes
    poses = np.stack([jpose[(k.robot_name, round(k.stamp, 3))]
                      for k in kfs])
    gen = MapCloudGenerator.of_config(group.cfg)
    got = gen.generate([k.cloud for k in kfs], poses,
                       first_flags=[k.first_keyframe for k in kfs])
    jkfs = [next(j for j in jgroup.db.keyframes + jgroup.db.new_keyframes
                 if (j.robot_name, round(j.stamp, 3))
                 == (k.robot_name, round(k.stamp, 3))) for k in kfs]
    want = jgroup.map_generator.generate(
        [j.cloud for j in jkfs], poses,
        first_flags=[j.first_keyframe for j in jkfs])
    _same_map(got, want)


def _same_map(got, want, least=100):
    """The same number of voxels, each point of one map within 1e-5 of
    its own point of the other (nearest neighbours, one to one)."""
    from scipy.spatial import cKDTree

    assert got.shape == want.shape and len(got) >= least
    dist, idx = cKDTree(want.astype(np.float64)).query(got)
    assert dist.max() <= 1e-5
    assert len(np.unique(idx)) == len(got)


def test_default_radius_removes_the_other_robots_points(world):
    """At the default robot_remove_points_radius (2 m) a keyframe's cloud
    loses the points near the other robot's current position, as in the
    JAX package, and the front end's covariances are dropped with it."""
    cloud_np = world["clouds"][3]
    near = cloud_np[0][cloud_np[1]][7]  # bravo stands on one of its points
    groups = []
    for Group, cfg, cloud in (
            (JShared, _jcfg(NAMES, robot_remove_points_radius=2.0),
             _jcloud),
            (SharedGraphSlam, _tcfg(NAMES, robot_remove_points_radius=2.0),
             _tcloud)):
        kw = {} if Group is JShared else {"device": "cpu"}
        g = Group(cfg, list(NAMES), **kw)
        for name, at in (("alpha", np.zeros(3)), ("bravo", near)):
            v = g.views[name]
            v.init_done = True
            v.trans_odom2map = se3np.pose_identity()
            v.last_odom_pose = se3np.pose_identity()
            v.last_odom_pose[:3] = at
        groups.append((g, cloud(*cloud_np)))
    (jg, jc), (g, c) = groups
    want = np.asarray(jg._remove_other_robot_points(
        jg.views["alpha"], se3np.pose_identity(), jc).mask)
    got = g._remove_other_robot_points(g.views["alpha"],
                                       se3np.pose_identity(), c)
    np.testing.assert_array_equal(got.mask.numpy(), want)
    assert (cloud_np[1] & ~want).sum() > 0
    assert (got.points[~got.mask] == 1e6).all()
    # through process_scan: the keyframe keeps the pruned cloud and no
    # covariances, which the tick's prefetch then computes for it
    g.process_scan("alpha", 0.0, se3np.pose_identity(), c,
                   source_covs=torch.from_numpy(world["covs"][3]))
    kf = g.db.keyframe_queue[-1]
    assert kf.gicp is None
    np.testing.assert_array_equal(kf.cloud.mask.numpy(), want)


@pytest.mark.parametrize("change", [
    dict(gps=dataclasses.replace(JSLAM_NO_MARGINALS.gps, enable_gps=True)),
    dict(enable_fill_first_cloud=True)])
def test_shared_graph_refuses_the_processors(world, change):
    """Each view owns its processors, flushed over its own robot's
    keyframes (item 12, once refused here): a GPS fix queued at alpha's
    stamps becomes priors on alpha's keyframes only; filling fills each
    robot's first keyframe. MrgSlam still refuses other robots (item
    14)."""
    from mrg_slam_tpu_torch.models.processors import GpsFix
    group = SharedGraphSlam(_tcfg(NAMES, **change), list(NAMES),
                            device="cpu")
    a, b = (group.views[n] for n in NAMES)
    assert a.gps_processor is not b.gps_processor
    for i in range(4):
        for k, n in enumerate(NAMES):
            lo = WINDOWS[n][0]
            p, m = world["clouds"][lo + i]
            group.process_scan(n, i * 0.1 + k * 0.05,
                               _odometry(world["traj"], [lo, lo + i], 3)[-1],
                               _tcloud(p, m))
        a.gps_processor.add_fix(GpsFix(i * 0.1, 48.0, 11.0 + 1e-5 * i,
                                       500.0))
    assert group.optimization_tick() is not None
    g = group.db.graph
    kfs = {n: group.robot_keyframes(n) for n in NAMES}
    assert all(kfs.values())
    if "gps" in change:
        assert g._priors.n == len(kfs["alpha"])
        assert set(g._priors.arrays["node_idx"][:g._priors.n]) == {
            k.node_id for k in kfs["alpha"]}
    else:
        assert g._priors.capacity == 0
        for n in NAMES:
            first = [k for k in kfs[n] if k.first_keyframe]
            assert len(first) == 1 and first[0].cloud.capacity > CAP
    with pytest.raises(NotImplementedError, match="item 14"):
        MrgSlam(_tcfg(NAMES), device="cpu")
