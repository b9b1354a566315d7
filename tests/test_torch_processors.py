"""The port's GPS, IMU and floor-coefficient processors, geodesy and NMEA
(models/processors.py, utils/geodesy.py, utils/nmea.py) and first-cloud
filling (models/graph_database.py) against the JAX package's, on the
same inputs.

Tolerances and why:
- geodesy and NMEA: equal (the same plain Python and numpy code), and
  tests/test_floor_and_processors.py's own bars.
- processor flushes: the prior and plane tables of the port's
  GraphDatabase equal the JAX package's, indices and types exactly,
  measurements and information within float32 rounding (rtol 1e-6: the
  IMU priors go through a float32 quaternion product, numpy here and
  jax.numpy there); the keyframes' attachments likewise.
- first-cloud filling through a tick: the filled cloud equals the JAX
  package's fill of the same cloud (the simple variant, within 1e-5 m).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mrg_slam_tpu.config import SlamConfig as JSlamConfig
from mrg_slam_tpu.config import OptimizerConfig as JOptimizerConfig
from mrg_slam_tpu.models import processors as jproc
from mrg_slam_tpu.models.floor_detection import FloorCoeffs as JFloorCoeffs
from mrg_slam_tpu.models.graph_database import GraphDatabase as JDatabase
from mrg_slam_tpu.ops import ground_fill as jfill
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.utils import geodesy as jgeo
from mrg_slam_tpu.utils import nmea as jnmea

from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.models import processors as tproc
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.models.floor_detection import FloorCoeffs
from mrg_slam_tpu_torch.models.graph_database import GraphDatabase
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.utils import geodesy as tgeo
from mrg_slam_tpu_torch.utils import nmea as tnmea
from mrg_slam_tpu_torch.utils import se3np

from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)


def test_geodesy_matches_jax():
    pts = [(49.0069, 8.4037), (0.0, 9.0), (-33.9, 151.2), (64.1, -21.9),
           (49.0001, 8.4001)]
    for lat, lon in pts:
        assert tgeo.latlon_to_utm(lat, lon) == jgeo.latlon_to_utm(lat, lon)
        assert tgeo.utm_zone(lat, lon) == jgeo.utm_zone(lat, lon)
        np.testing.assert_array_equal(tgeo.geodetic_to_ecef(lat, lon, 100.0),
                                      jgeo.geodetic_to_ecef(lat, lon, 100.0))
    # tests/test_floor_and_processors.py's known point and ENU check
    e, n, z = tgeo.latlon_to_utm(49.0069, 8.4037)
    assert z == 32 and abs(e - 456391.2) < 1.0 and abs(n - 5428394.1) < 1.0
    e0, n0, _ = tgeo.latlon_to_utm(0.0, 9.0)
    assert abs(e0 - 500000) < 1e-6 and abs(n0) < 1e-6
    enu, jenu = tgeo.LocalCartesian(49.0, 8.4, 0.0), \
        jgeo.LocalCartesian(49.0, 8.4, 0.0)
    p = enu.forward(49.0001, 8.4001, 0.0)
    np.testing.assert_array_equal(p, jenu.forward(49.0001, 8.4001, 0.0))
    e0, n0, _ = tgeo.latlon_to_utm(49.0, 8.4)
    e1, n1, _ = tgeo.latlon_to_utm(49.0001, 8.4001)
    np.testing.assert_allclose(p[:2], [e1 - e0, n1 - n0], atol=0.25)


@pytest.mark.parametrize("sentence", [
    "$GPRMC,123519,A,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W*6A",
    "$GPRMC,123519,V,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W*7D",
    "$GPRMC,bad*00",
    "$GPGGA,123519,4807.038,N,01131.000,E*00"])
def test_nmea_matches_jax(sentence):
    assert tnmea.checksum_ok(sentence) == jnmea.checksum_ok(sentence)
    got, want = tnmea.parse_gprmc(sentence), jnmea.parse_gprmc(sentence)
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if sentence.endswith("*6A"):
        assert got.valid and abs(got.latitude - 48.1173) < 1e-3
        assert abs(got.longitude - 11.5167) < 1e-3
    assert tnmea.degmin_to_deg("4807.038", "S") == \
        jnmea.degmin_to_deg("4807.038", "S")


def _jslam(**kw):
    return JSlamConfig(capacity_keyframes=32, capacity_edges=64,
                       optimizer=JOptimizerConfig(solver_backend="dense"),
                       **kw)


POSES = [se3np.pose_identity(),
         np.asarray([10, 0, 0, 1, 0, 0, 0], np.float32),
         np.asarray([20, 2, 0, 0.9659258, 0, 0, 0.2588190], np.float32),
         np.asarray([30, 5, 1, 0.9238795, 0, 0.3826834, 0], np.float32)]


def _dbs(**kw):
    """The same store in both packages, four keyframes flushed."""
    jcfg = _jslam(**kw)
    jdb = JDatabase(jcfg)
    tdb = GraphDatabase(config_from_fields(dataclasses.asdict(jcfg)),
                        device="cpu")
    jk, tk = [], []
    for i, pose in enumerate(POSES):
        jk.append(jdb.add_odom_keyframe(float(i), pose, float(i),
                                        JCloud.empty(8)))
        tk.append(tdb.add_odom_keyframe(float(i), pose, float(i),
                                        PointCloud.empty(8, device="cpu")))
        jdb.flush_keyframe_queue(se3np.pose_identity())
        tdb.flush_keyframe_queue(se3np.pose_identity())
    assert tdb.graph.cap == {k: v for k, v in jdb.graph.cap.items()}
    return jdb, tdb, jk, tk


def _same_tables(jdb, tdb):
    for name in ("_priors", "_pl_edges", "_pl_priors", "_pl_pl"):
        a, b = getattr(tdb.graph, name), getattr(jdb.graph, name)
        assert a.n == b.n and a.capacity == b.capacity
        for k, v in a.arrays.items():
            w = b.arrays[k]
            if v.dtype == np.float32:
                np.testing.assert_allclose(v, w, rtol=1e-6, atol=1e-7)
            else:
                np.testing.assert_array_equal(v, w)
    np.testing.assert_array_equal(tdb.graph.planes, jdb.graph.planes)
    np.testing.assert_array_equal(tdb.graph._plane_fixed,
                                  jdb.graph._plane_fixed)


@pytest.mark.parametrize("enu,with_alt", [(False, True), (False, False),
                                          (True, True)])
def test_gps_flush_matches_jax(enu, with_alt):
    """UTM or ENU, XYZ priors or, without an altitude, XY priors; fixes
    matched within the tolerance, the rest dropped or kept as the JAX
    package keeps them."""
    gps = dict(enable_gps=True, gps_use_enu=enu,
               gps_enu_origin_from_msg=True)
    jdb, tdb, jk, tk = _dbs(gps=jproc.GpsConfig(**gps))
    alt = 110.0 if with_alt else float("nan")
    fixes = [(0.05, 49.0, 8.4), (1.02, 49.0001, 8.4), (2.5, 49.0002, 8.4001),
             (3.1, 49.0003, 8.4002), (9.0, 49.1, 8.5)]
    jg, tg = jproc.GpsProcessor(jdb.cfg.gps), tproc.GpsProcessor(tdb.cfg.gps)
    for s, lat, lon in fixes:
        jg.add_fix(jproc.GpsFix(s, lat, lon, alt))
        tg.add_fix(tproc.GpsFix(s, lat, lon, alt))
    assert tg.flush(tdb, tk) == jg.flush(jdb, jk) is True
    assert tdb.graph._priors.n == 3  # the 2.5 s fix matches nothing
    _same_tables(jdb, tdb)
    for a, b in zip(tk, jk):
        assert (a.utm_coord is None) == (b.utm_coord is None)
        if b.utm_coord is not None:
            np.testing.assert_array_equal(a.utm_coord, b.utm_coord)
    assert [f.stamp for f in tg.queue] == [f.stamp for f in jg.queue]
    # a second flush adds nothing to keyframes that have their fix
    assert tg.flush(tdb, tk) == jg.flush(jdb, jk)
    assert tdb.graph._priors.n == jdb.graph._priors.n


def test_imu_flush_matches_jax():
    imu = jproc.ImuConfig(enable_imu_orientation=True,
                          enable_imu_acceleration=True)
    jdb, tdb, jk, tk = _dbs(imu=imu)
    base = np.asarray([0.1, 0.0, 0.2, 0.9961947, 0.0, 0.0871557, 0.0],
                      np.float32)
    jp, tp = jproc.ImuProcessor(jdb.cfg.imu, base), \
        tproc.ImuProcessor(tdb.cfg.imu, base)
    rng = np.random.default_rng(0)
    for s in (0.02, 1.1, 2.95, 7.0):
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        acc = (np.asarray([0, 0, 9.81]) + rng.normal(0, 0.3, 3)).astype(
            np.float32)
        jp.add_sample(jproc.ImuSample(s, q, acc))
        tp.add_sample(tproc.ImuSample(s, q, acc))
    assert tp.flush(tdb, tk) == jp.flush(jdb, jk) is True
    assert tdb.graph._priors.n == 6  # quaternion + vector, three keyframes
    _same_tables(jdb, tdb)
    for a, b in zip(tk, jk):
        assert (a.orientation is None) == (b.orientation is None)
        if b.orientation is not None:
            np.testing.assert_allclose(a.orientation, b.orientation,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(a.acceleration, b.acceleration,
                                       rtol=1e-6, atol=1e-6)
    # the matched keyframes are done: a new sample near them adds nothing
    jp.add_sample(jproc.ImuSample(0.0, q, acc))
    tp.add_sample(tproc.ImuSample(0.0, q, acc))
    assert tp.flush(tdb, tk) == jp.flush(jdb, jk)
    assert tdb.graph._priors.n == 6


def test_floor_flush_matches_jax_and_solves():
    jdb, tdb, jk, tk = _dbs(floor_coeffs=jproc.FloorCoeffsConfig(
        enable_floor_coeffs=True))
    jp = jproc.FloorCoeffsProcessor(jdb.cfg.floor_coeffs)
    tp = tproc.FloorCoeffsProcessor(tdb.cfg.floor_coeffs)
    for s, c in ((0.0, [0, 0, 1, 1.5]), (2.0000001, [0.05, 0, 0.99, 1.4]),
                 (2.5, [0, 0, 1, 2.0]), (3.0, [0, 0.1, 0.99, 0.5])):
        c = np.asarray(c, np.float32)
        jp.add_coeffs(JFloorCoeffs(s, c))
        tp.add_coeffs(FloorCoeffs(s, c))
    assert tp.flush(tdb, tk) == jp.flush(jdb, jk) is True
    assert tp.plane_node_id == jp.plane_node_id == 0
    assert tdb.graph.num_plane_edges == jdb.graph.num_plane_edges == 3
    assert [f.stamp for f in tp.queue] == [f.stamp for f in jp.queue] == [2.5]
    _same_tables(jdb, tdb)
    for a, b in zip(tk, jk):
        assert (a.floor_coeffs is None) == (b.floor_coeffs is None)
    # the store's plane edges solve: poses finite, the fixed plane kept
    tdb.graph.optimize(8)
    assert np.isfinite(tdb.graph.poses).all()
    np.testing.assert_array_equal(tdb.graph.planes[0], [0, 0, 1, 0])


@pytest.mark.parametrize("simple", [True, False])
def test_first_cloud_filling_through_a_tick(simple):
    """MrgSlam fills its first keyframe's cloud at the tick's flush; the
    simple variant equals the JAX package's fill of the same cloud."""
    rng = np.random.default_rng(1)
    pts = np.concatenate([
        np.stack([rng.uniform(-8, 8, 400), rng.uniform(-8, 8, 400),
                  rng.normal(-1.5, 0.02, 400)], 1),
        rng.uniform(-8, 8, (100, 3))]).astype(np.float32)
    jcfg = dataclasses.replace(
        _jslam(enable_fill_first_cloud=True,
               fill_first_cloud_simple=simple, fill_first_cloud_radius=2.0),
        own_name="atlas", multi_robot_names=("atlas",),
        capacity_keyframe_points=512)
    slam = MrgSlam(config_from_fields(dataclasses.asdict(jcfg)),
                   device="cpu")
    cloud = PointCloud.from_array(pts, 512, device="cpu")
    pose = np.asarray([1.0, 2.0, 0.0, 0.9659258, 0, 0, 0.2588190],
                      np.float32)
    slam.process_scan(0.0, pose, cloud)
    assert slam.optimization_tick() is not None
    kf = slam.db.own_keyframes()[0]
    assert kf.first_keyframe and kf.cloud.capacity > 512
    assert int(kf.cloud.mask.sum()) > len(pts) + 50
    if simple:
        want = jfill.fill_ground_plane_simple(
            JCloud(jnp.asarray(cloud.points.numpy()),
                   jnp.asarray(cloud.mask.numpy())), pose, 2.0,
            jcfg.map_cloud_resolution)
        np.testing.assert_array_equal(kf.cloud.mask.numpy(),
                                      np.asarray(want.mask))
        np.testing.assert_allclose(kf.cloud.points.numpy(),
                                   np.asarray(want.points), atol=1e-5)
