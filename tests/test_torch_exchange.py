"""The port's graph exchange against the JAX package's, on the same numpy
inputs: the messages, the uuid merge of a delta graph, the exchange
services of two `MrgSlam`s, other-robot point removal and the
asynchronous tick.

Inputs: the small world of tests/test_torch_backend.py (1.2 laps of a
12 m circle, 256-lane clouds and their GICP covariances). Two robots
survey overlapping arcs of it (alpha frames 0-35, bravo frames 30-65,
tests/test_torch_shared.py's windows), each with its own seeded odometry
drift from its own start and a start pose at the truth of its first
frame; they tick every 12 frames, then each sends its slam-pose
broadcast to the other.

Tolerances and why:
- `quantize_cloud`: the same uint16 offsets and origin as the JAX
  package's, bit for bit (both compute them in numpy on the host); a
  round trip stays within half a step of the original points.
- `GraphMsg.nbytes`, quantized or not: equal (shapes only).
- The merge of one JAX-made delta graph (converted by
  `convert.graph_msg_from_numpy`) by both packages' `flush_graph_queue`:
  the same nodes, edges by type, loops in the loop manager, odometry
  links and latest keyframe; estimates within 1e-6 (they are copied).
- The two-robot drive, one robot in each proximity mode: the same
  exchange decision at every slam-pose broadcast, the same remote keyframes
  merged, the same keyframes and loops; trajectories, other robots'
  odom->map and their map-frame positions within 1e-2 of the JAX
  package's, the bar of tests/test_torch_slice.py for float32 solves in
  two libraries: odom->map is a solved keyframe estimate composed with a
  fixed odometry pose, so it differs as the solved estimates do (up to
  1.1e-3 in z measured here; 1e-4 does not hold). Its
  pair buckets are padded to 128 rows on the JAX side, as
  tests/test_torch_slice.py pads them.
- Point removal (tests/test_round2_backend.py:220-287 of the JAX package,
  ported): other robots' odom->map within 1e-3 of the truth, the points
  near them gone, none removed for a robot never merged.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu import config as jconfig
from mrg_slam_tpu.models.backend import MrgSlam as JMrgSlam
from mrg_slam_tpu.models.graph_database import GraphDatabase as JDatabase
from mrg_slam_tpu.models.keyframe import new_uuid
from mrg_slam_tpu.models.loop_detector import LoopManager as JLoopManager
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.parallel import messages as jmsg

from mrg_slam_tpu_torch.convert import config_from_fields, graph_msg_from_numpy
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.models.graph_database import GraphDatabase
from mrg_slam_tpu_torch.models.loop_detector import LoopManager
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.parallel import messages
from mrg_slam_tpu_torch.parallel.messages import PoseWithName
from mrg_slam_tpu_torch.utils import se3np

from test_torch_backend import CAP, make_world
from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)
from test_torch_shared import (WINDOWS, _init_pose, _jcloud, _odometry,
                               _tcloud)
from test_torch_slice import JSLAM_NO_MARGINALS

NAMES = ("alpha", "bravo")
MODES = {"alpha": "CURRENT_PROXIMITY", "bravo": "PATH_PROXIMITY"}
TICK_EVERY = 12


@pytest.fixture(scope="module")
def world():
    return make_world()


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

def _seeded_cloud(seed, cap=300, n=220):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30.0, 30.0, (cap, 3)).astype(np.float32)
    mask = np.zeros(cap, bool)
    mask[rng.choice(cap, n, replace=False)] = True
    pts[~mask] = 1e6
    return pts, mask


def test_quantize_cloud_matches_jax_and_round_trips():
    pts, mask = _seeded_cloud(0)
    jq = jmsg.quantize_cloud(JCloud(jnp.asarray(pts), jnp.asarray(mask)))
    q = messages.quantize_cloud(_tcloud(pts, mask))
    assert q.offsets.dtype == np.uint16
    np.testing.assert_array_equal(q.offsets, jq.offsets)
    assert q.origin.tobytes() == np.asarray(jq.origin).tobytes()
    assert (q.scale, q.capacity, q.nbytes) == (jq.scale, jq.capacity,
                                               jq.nbytes)
    back = messages.dequantize_cloud(q, device="cpu")
    assert back.capacity == 300 and int(back.mask.sum()) == 220
    got = back.points.numpy()[back.mask.numpy()]
    assert np.abs(got - pts[mask]).max() <= q.scale / 2 + 1e-5


def _jgraph_msg(name="bravo", n_kf=5, seed=1, with_extras=True):
    """A JAX-made delta graph: n_kf keyframes along a line with 128-lane
    clouds, their odometry edges and a loop; with `with_extras`, also an
    anchor edge between two of them and an edge to a keyframe not sent."""
    rng = np.random.default_rng(seed)
    slam_uuid = new_uuid()
    kfs = []
    for i in range(n_kf):
        est = np.asarray([5.0 + i, 8.0 + 0.1 * i, 0.0, 1, 0, 0, 0],
                         np.float32)
        pts = rng.normal(0.0, 5.0, (100, 3)).astype(np.float32)
        kfs.append(jmsg.KeyFrameMsg(
            robot_name=name, uuid=new_uuid(), slam_uuid=slam_uuid,
            stamp=0.1 * i, odom_counter=i, first_keyframe=i == 0,
            static_keyframe=False, accum_distance=float(i), estimate=est,
            cloud=JCloud.from_array(pts, capacity=128)))
    info = np.eye(6, dtype=np.float32) * 100.0

    def edge(kind, a, b):
        rel = se3np.pose_between(a.estimate, b.estimate)
        return jmsg.EdgeMsg(type=kind, uuid=new_uuid(), from_uuid=a.uuid,
                            to_uuid=b.uuid, relative_pose=rel,
                            information=info)

    edges = [edge("odom", kfs[i + 1], kfs[i]) for i in range(n_kf - 1)]
    edges.append(edge("loop", kfs[-1], kfs[0]))
    if with_extras:
        edges.append(edge("anchor", kfs[0], kfs[1]))
        stray = dataclasses.replace(edges[0], uuid=new_uuid(),
                                    to_uuid=new_uuid())
        edges.append(stray)
    odom = np.asarray([float(n_kf), 0, 0, 1, 0, 0, 0], np.float32)
    return jmsg.GraphMsg(robot_name=name,
                         latest_keyframe_uuid=kfs[-1].uuid,
                         latest_keyframe_odom=odom, keyframes=kfs,
                         edges=edges)


def _numpy_msg(msg):
    """The JAX package's GraphMsg with its clouds fetched as numpy."""
    return dataclasses.replace(msg, keyframes=[dataclasses.replace(
        k, cloud=JCloud(np.asarray(k.cloud.points), np.asarray(k.cloud.mask))
        if isinstance(k.cloud, JCloud) else k.cloud) for k in msg.keyframes])


def test_graph_msg_nbytes_match_jax():
    jm = _jgraph_msg()
    m = graph_msg_from_numpy(_numpy_msg(jm), device="cpu")
    assert m.nbytes() == jm.nbytes() > 0
    jq = jmsg.quantize_graph_msg(jm)
    q = messages.quantize_graph_msg(m)
    assert q.wire_nbytes == jq.wire_nbytes == q.nbytes() < m.nbytes()
    for k, jk in zip(q.keyframes, jq.keyframes):
        np.testing.assert_array_equal(k.cloud.offsets, jk.cloud.offsets)
    back = messages.dequantize_graph_msg(q, device="cpu")
    assert back.wire_nbytes == q.wire_nbytes
    assert all(isinstance(k.cloud, PointCloud) and k.cloud.capacity == 128
               for k in back.keyframes)
    # a quantized JAX message converts with its wire form kept
    mq = graph_msg_from_numpy(jq, device="cpu")
    assert mq.nbytes() == jq.nbytes()


# ---------------------------------------------------------------------------
# the uuid merge
# ---------------------------------------------------------------------------

def _own_chain(db, cloud):
    for i in range(3):
        db.add_odom_keyframe(float(i), np.asarray([i, 0, 0, 1, 0, 0, 0],
                                                  np.float32),
                             float(i), cloud)
    db.flush_keyframe_queue(se3np.pose_identity())


def _merge_state(db, lm):
    kfs = db.uuid_keyframe_map
    remote = sorted((k for k in kfs.values() if k.robot_name == "bravo"),
                    key=lambda k: k.odom_counter)
    return dict(
        nodes=db.graph.num_nodes, edges=db.graph.num_edges,
        types=collections.Counter(e.type for e in db.edges),
        loops={(a, b): (loop.key1.uuid, loop.key2.uuid)
               for a, d in lm._map.items() for b, loop in d.items()},
        links=[(k.prev_edge.uuid if k.prev_edge else None,
                k.next_edge.uuid if k.next_edge else None)
               for k in remote],
        remote=[k.uuid for k in remote],
        last={n: (u, tuple(o)) for n, (u, o) in db.others_last_kf.items()},
        poses=np.stack([db.graph.poses[k.node_id] for k in remote]))


def test_flush_graph_queue_matches_jax():
    """One JAX-made delta graph merged by both packages into a store with
    its own three-keyframe chain, then a second graph that repeats the
    first's keyframes and edges and adds one of each: the duplicates, the
    remote anchor and the edge to a keyframe not sent are skipped."""
    jcfg = dataclasses.replace(
        JSLAM_NO_MARGINALS, multi_robot_names=NAMES,
        inf_matrix=jconfig.InformationMatrixConfig(
            use_const_inf_matrix=True))
    jdb, jlm = JDatabase(jcfg), JLoopManager()
    db, lm = GraphDatabase(config_from_fields(dataclasses.asdict(jcfg)),
                           device="cpu"), LoopManager()
    pts, mask = _seeded_cloud(2, cap=CAP, n=200)
    _own_chain(jdb, _jcloud(pts, mask))
    _own_chain(db, _tcloud(pts, mask))

    first = _jgraph_msg(n_kf=5)
    more = _jgraph_msg(n_kf=6, with_extras=False)
    # the second message resends the first's keyframes and edges (same
    # uuids) and adds a sixth keyframe with its odometry edge
    kf6 = dataclasses.replace(more.keyframes[5],
                              slam_uuid=first.keyframes[0].slam_uuid)
    rel = se3np.pose_between(kf6.estimate, first.keyframes[4].estimate)
    e6 = jmsg.EdgeMsg("odom", new_uuid(), kf6.uuid, first.keyframes[4].uuid,
                      rel, np.eye(6, dtype=np.float32))
    second = dataclasses.replace(first, keyframes=first.keyframes + [kf6],
                                 edges=first.edges + [e6],
                                 latest_keyframe_uuid=kf6.uuid)
    states = []
    for msg in (first, second):
        jdb.add_graph_msg(msg)
        db.add_graph_msg(graph_msg_from_numpy(_numpy_msg(msg),
                                              device="cpu"))
        assert jdb.flush_graph_queue(jlm) and db.flush_graph_queue(lm)
        want, got = _merge_state(jdb, jlm), _merge_state(db, lm)
        np.testing.assert_allclose(got.pop("poses"), want.pop("poses"),
                                   rtol=0, atol=1e-6)
        assert got == want
        states.append(got)
    assert not db.flush_graph_queue(lm)  # nothing left
    a, b = states
    # 3 own + 1 anchor; 5 then 6 remote nodes; own anchor + 2 odom edges,
    # then 4 remote odom and the loop, then the sixth's odom edge
    assert (a["nodes"], b["nodes"]) == (4 + 5, 4 + 6)
    assert a["types"] == {"anchor": 1, "odom": 6, "loop": 1}
    assert b["types"] == {"anchor": 1, "odom": 7, "loop": 1}
    assert len(a["loops"]) == 1
    assert b["links"][4][0] is not None and b["links"][5][1] is None


# ---------------------------------------------------------------------------
# the services: two MrgSlams exchanging graphs
# ---------------------------------------------------------------------------

def _exchange_jcfg(name, mode, **change):
    loop = dataclasses.replace(JSLAM_NO_MARGINALS.loop,
                               capacity_candidates=2,
                               accum_distance_thresh_other_robot=2.0)
    # the robots keep ~24 m apart on the circle: CURRENT_PROXIMITY asks
    # within 30 m, PATH_PROXIMITY within 9 m of a keyframe once the paths
    # cross; a 2 s delay between two exchanges gates every other tick
    ex = jconfig.GraphExchangeConfig(
        graph_exchange_mode=mode, graph_request_min_accum_dist=1.0,
        graph_request_min_time_delay=2.0,
        graph_request_max_robot_dist=(30.0 if mode == "CURRENT_PROXIMITY"
                                      else 9.0))
    return dataclasses.replace(JSLAM_NO_MARGINALS, own_name=name,
                               multi_robot_names=NAMES, loop=loop,
                               exchange=ex, **change)


def _drive_pair(world, slams, cloud, covs):
    """Both robots in lock step, each odom broadcast to the other; every
    TICK_EVERY frames each ticks and sends its slam pose, whose exchange
    decision is recorded -> [(frame, receiver, decided)]."""
    odo = {n: _odometry(world["traj"], range(*WINDOWS[n]), seed=11 + k)
           for k, n in enumerate(NAMES)}
    n_local = max(hi - lo for lo, hi in WINDOWS.values())
    decisions = []

    def request(peer, req):
        return slams[peer].handle_publish_graph(req)

    for i in range(n_local):
        for n in NAMES:
            lo, hi = WINDOWS[n]
            if lo + i >= hi:
                continue
            bc = slams[n].process_scan(i * 0.1, odo[n][i],
                                       cloud(*world["clouds"][lo + i]),
                                       source_covs=covs(world["covs"][lo + i]))
            for other in NAMES:
                if other != n:
                    slams[other].on_odom_broadcast(bc)
        if (i + 1) % TICK_EVERY == 0:
            for n in NAMES:
                slams[n].optimization_tick(now=i * 0.1)
            for n in NAMES:
                sp = slams[n].slam_pose_broadcast(i * 0.1)
                for other in NAMES:
                    if other != n and sp is not None:
                        decisions.append((i, other, slams[other].
                                          on_slam_pose_broadcast(
                                              sp, now=i * 0.1,
                                              request_fn=request)))
    for n in NAMES:
        slams[n].optimization_tick(now=n_local * 0.1)
    return decisions


def _keyframes(db):
    return sorted((k.robot_name, round(k.stamp, 3))
                  for k in db.keyframes + db.new_keyframes
                  if k.odom_counter >= 0)


def _loops(db):
    kfs = db.uuid_keyframe_map

    def key(kf):
        return kf.robot_name, round(kf.stamp, 3)

    return sorted((key(kfs[e.from_uuid]), key(kfs[e.to_uuid]))
                  for e in db.edges if e.type == "loop")


@pytest.fixture(scope="module")
def exchange(world):
    """One drive of both packages, alpha deciding in CURRENT_PROXIMITY
    mode and bravo in PATH_PROXIMITY mode."""
    inits = {n: _init_pose(world["traj"][lo]) for n, (lo, _) in
             WINDOWS.items()}
    jcfgs = {n: _exchange_jcfg(n, MODES[n], init_pose=inits[n])
             for n in NAMES}
    jslams = {n: JMrgSlam(c) for n, c in jcfgs.items()}
    for s in jslams.values():
        s.loop_detector.runner.MIN_BUCKET = 128  # one pair program
    jdec = _drive_pair(world, jslams, _jcloud, jnp.asarray)
    slams = {n: MrgSlam(config_from_fields(dataclasses.asdict(c)),
                        device="cpu") for n, c in jcfgs.items()}
    dec = _drive_pair(world, slams, _tcloud, torch.from_numpy)
    return jslams, jdec, slams, dec


@pytest.mark.parametrize("n", NAMES, ids=[MODES[n] for n in NAMES])
def test_exchange_services_match_jax(exchange, n):
    """The exchange decisions of robot `n` (alpha decides by the other's
    current position, bravo by its path), what it merged and solved."""
    jslams, jdec, slams, dec = exchange
    mine = [d for _, r, d in dec if r == n]
    assert mine == [d for _, r, d in jdec if r == n]
    assert any(mine) and not all(mine)
    s, js = slams[n], jslams[n]
    assert _keyframes(s.db) == _keyframes(js.db)
    assert {k[0] for k in _keyframes(s.db)} == set(NAMES)  # merged
    assert _loops(s.db) == _loops(js.db)
    assert s.sent_graph_bytes == js.sent_graph_bytes
    assert s.received_graph_bytes == js.received_graph_bytes
    other = [o for o in NAMES if o != n][0]
    np.testing.assert_allclose(s.others_odom2map[other],
                               js.others_odom2map[other], rtol=0, atol=1e-2)
    np.testing.assert_allclose(s.others_map_poses[other],
                               js.others_map_poses[other], rtol=0, atol=1e-2)
    t, jt = s.trajectory(), js.trajectory()
    assert t.shape == jt.shape and len(t) >= 10
    assert np.abs(t[:, :3] - jt[:, :3]).max() < 1e-2
    assert tuple(map(len, s.get_graph_uuids())) == tuple(
        map(len, js.get_graph_uuids()))


def test_request_graphs_and_init_pose(world):
    """RequestGraphs pulls without the gates; set_init_pose takes effect
    only before the first keyframe."""
    cfg = config_from_fields(dataclasses.asdict(
        _exchange_jcfg("alpha", "CURRENT_PROXIMITY")))
    a = MrgSlam(cfg, device="cpu")
    b = MrgSlam(dataclasses.replace(cfg, own_name="bravo"), device="cpu")
    pose = np.asarray([1.0, 2.0, 0, 1, 0, 0, 0], np.float32)
    a.set_init_pose(pose)
    for i in range(4):
        p, m = world["clouds"][30 + i]
        b.process_scan(i * 0.1, world["odom"][30 + i], _tcloud(p, m))
        a.process_scan(i * 0.1, world["odom"][i],
                       _tcloud(*world["clouds"][i]))
    b.optimization_tick()
    a.optimization_tick()
    a.set_init_pose(se3np.pose_identity())  # too late: ignored
    np.testing.assert_array_equal(a.init_pose, pose)
    np.testing.assert_allclose(a.trajectory()[0, :3], pose[:3], atol=1e-4)
    assert a.request_graphs(["alpha", "bravo"], 1.0,
                            lambda n, req: b.handle_publish_graph(req)) == 1
    a.optimization_tick(now=1.0)
    assert len(_keyframes(a.db)) == len(a.db.own_keyframes()) + len(
        b.db.own_keyframes())
    # a second pull sends nothing a already has
    msg = b.handle_publish_graph(a._graph_request())
    assert not msg.keyframes and not msg.edges


# ---------------------------------------------------------------------------
# other-robot point removal (JAX tests/test_round2_backend.py:220-287)
# ---------------------------------------------------------------------------

def _removal_cfg(**kw):
    jcfg = dataclasses.replace(
        JSLAM_NO_MARGINALS, multi_robot_names=("atlas", "bestla"),
        robot_remove_points_radius=2.0, **kw)
    return config_from_fields(dataclasses.asdict(jcfg))


def test_others_odom2map_estimated_and_applied():
    cfg = _removal_cfg(inf_matrix=jconfig.InformationMatrixConfig(
        use_const_inf_matrix=True))
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, candidate_max_xy_distance=0.0))
    slam = MrgSlam(cfg, device="cpu")
    for i in range(3):
        slam.db.add_odom_keyframe(
            float(i), np.asarray([i * 1.0, 0, 0, 1, 0, 0, 0], np.float32),
            accum_distance=float(i), cloud=PointCloud.empty(64, "cpu"))
    slam.optimization_tick(now=3.0)
    # bestla's odom frame is rotated and shifted against the map
    t_b = np.concatenate([[2.0, -1.0, 0.0],
                          se3np.rpy_to_quat(0, 0, 0.7)]).astype(np.float32)
    world_poses = [np.asarray([5.0 + i, 8.0, 0, 1, 0, 0, 0], np.float32)
                   for i in range(4)]
    kmsgs = [messages.KeyFrameMsg(
        robot_name="bestla", uuid=new_uuid(), slam_uuid="b", stamp=float(i),
        odom_counter=i, first_keyframe=False, static_keyframe=False,
        accum_distance=float(i), estimate=wp,
        cloud=PointCloud.empty(64, "cpu")) for i, wp in enumerate(world_poses)]
    slam.db.add_graph_msg(messages.GraphMsg(
        robot_name="bestla", latest_keyframe_uuid=kmsgs[-1].uuid,
        latest_keyframe_odom=se3np.pose_compose(se3np.pose_inverse(t_b),
                                                world_poses[-1]),
        keyframes=kmsgs, edges=[]))
    slam.optimization_tick(now=4.0)
    got = slam.others_odom2map["bestla"]
    np.testing.assert_allclose(got[:3], t_b[:3], atol=1e-3)
    assert se3np.rotation_angle(se3np.pose_between(got, t_b)[3:]) < 1e-3
    # bestla's odom broadcast lands in this robot's map frame through it
    o_b = np.asarray([1.0, 2.0, 0, 1, 0, 0, 0], np.float32)
    slam.on_odom_broadcast(PoseWithName("bestla", 5.0, o_b, 9.0))
    expect = se3np.pose_compose(t_b, o_b)
    np.testing.assert_allclose(slam.others_map_poses["bestla"][:3],
                               expect[:3], atol=1e-3)
    arr = slam.others_poses_in_map(5.0)
    assert len(arr) == 1 and arr[0].robot_name == "bestla"
    assert arr[0].accum_dist == 9.0
    # a scan point at bestla's position goes, a far one stays
    own_odom = se3np.pose_identity()
    own_map = se3np.pose_compose(slam.trans_odom2map, own_odom)
    b_in_base = se3np.pose_apply(se3np.pose_inverse(own_map), expect[:3])
    far_pt = b_in_base + np.asarray([10.0, 10.0, 0.0], np.float32)
    cloud = PointCloud.from_array(np.stack([b_in_base, far_pt]), 64, "cpu")
    out = slam._remove_other_robot_points(own_odom, cloud)
    kept = out.points.numpy()[out.mask.numpy()]
    assert len(kept) == 1
    np.testing.assert_allclose(kept[0], far_pt, atol=1e-4)


def test_unknown_robot_not_removed():
    """Before any merge another robot's odom broadcast cannot be placed in
    this robot's map frame, so no point is removed for it
    (mrg_slam_component.cpp:660-683)."""
    slam = MrgSlam(_removal_cfg(), device="cpu")
    slam.on_odom_broadcast(PoseWithName("bestla", 0.0,
                                        se3np.pose_identity(), 0.0))
    cloud = PointCloud.from_array(np.zeros((1, 3), np.float32), 64, "cpu")
    out = slam._remove_other_robot_points(se3np.pose_identity(), cloud)
    assert out is cloud and int(out.mask.sum()) == 1


def test_process_scan_drops_covariances_of_a_pruned_cloud(world):
    """The front end's covariances ride on a keyframe only when point
    removal left its cloud as it was (the JAX package's
    backend.py:148-153): with another robot placed on the scan the
    keyframe keeps the pruned cloud and no covariances, which the tick's
    prefetch then computes for it; with none placed it keeps both."""
    pts, mask = world["clouds"][3]
    covs = torch.from_numpy(world["covs"][3])
    slam = MrgSlam(_removal_cfg(), device="cpu")
    slam.process_scan(0.0, se3np.pose_identity(), _tcloud(pts, mask),
                      source_covs=covs)
    kf = slam.db.keyframe_queue[-1]
    assert kf.gicp is not None and kf.gicp.covs is covs
    far = se3np.pose_identity()
    far[0] = 10.0  # a keyframe step on
    # bestla stands on one of the scan's points, in the map frame
    slam.others_map_poses["bestla"] = np.concatenate(
        [pts[mask][7] + far[:3], [1, 0, 0, 0]]).astype(np.float32)
    slam.process_scan(0.1, far, _tcloud(pts, mask), source_covs=covs)
    kf = slam.db.keyframe_queue[-1]
    assert kf.gicp is None
    assert int(kf.cloud.mask.sum()) < int(mask.sum())
    slam.optimization_tick()
    assert kf.gicp is not None and kf.gicp.covs.shape == (CAP, 3, 3)


# ---------------------------------------------------------------------------
# the asynchronous tick
# ---------------------------------------------------------------------------

def test_async_tick_loses_no_keyframe(world):
    """optimization_tick_async runs on a worker thread while scans keep
    coming in (the reference's optimization timer beside its cloud
    callback): no keyframe is lost to the flush and append race, and the
    graph holds the keyframes and odometry edges of the synchronous
    drive, its trajectory within 0.1 m of it (the bar of the JAX
    package's tests/test_coordinator_scale.py: ticks that start later
    see other keyframes as new, so loop candidates may differ)."""
    cfg = config_from_fields(dataclasses.asdict(JSLAM_NO_MARGINALS))
    runs = []
    for use_async in (True, False):
        slam = MrgSlam(cfg, device="cpu")
        futures = []
        for i in range(40):
            slam.process_scan(i * 0.1, world["odom"][i],
                              _tcloud(*world["clouds"][i]),
                              source_covs=torch.from_numpy(world["covs"][i]))
            if (i + 1) % 8 == 0:
                if use_async:
                    futures.append(slam.optimization_tick_async(i * 0.1))
                else:
                    slam.optimization_tick(i * 0.1)
        for f in futures:
            f.result(timeout=300)
        slam.optimization_tick(now=4.0)  # drain
        runs.append(slam)
    a, s = runs
    assert a._tick_executor is not None and s._tick_executor is None
    a._tick_executor.shutdown()
    admitted = a.db.odom_keyframe_counter
    assert admitted == s.db.odom_keyframe_counter >= 10
    assert len([k for k in a.db.keyframes + a.db.new_keyframes
                if k.node_id is not None]) == admitted
    assert not a.db.keyframe_queue
    assert _keyframes(a.db) == _keyframes(s.db)
    assert sorted((e.from_readable, e.to_readable) for e in a.db.edges
                  if e.type == "odom") == sorted(
        (e.from_readable, e.to_readable) for e in s.db.edges
        if e.type == "odom")
    assert a.db.graph.chi2_final <= a.db.graph.chi2_initial + 1e-6
    assert np.abs(a.trajectory()[:, :3] - s.trajectory()[:, :3]).max() < 0.1
