"""The port's reference-YAML config and `param:=value` overrides against
the JAX package's (mrg_slam_tpu/config.py:21-26, 337-380 and
mrg_slam_tpu/launch.py:27-52): the same dict gives the same EngineConfig,
field by field (`dataclasses.asdict`), exactly.

The YAML is built here, not read from the reference's checkout: it covers
every section in both nestings (`<section>: {ros__parameters: {...}}`
and flat), `/**` with `model_namespace`, a list `multi_robot_names` (a
tuple in the config), a list `init_pose` (kept a list, as the JAX
package keeps it), and keys that no dataclass declares (ignored).
"""

import copy
import dataclasses

import pytest
import yaml

from mrg_slam_tpu import launch as jlaunch
from mrg_slam_tpu.config import EngineConfig as JEngineConfig

from mrg_slam_tpu_torch import launch as tlaunch
from mrg_slam_tpu_torch.config import EngineConfig as TEngineConfig

_SECTIONS = {
    "/**": {"model_namespace": "husky7", "use_sim_time": True},
    "lidar2base_publisher": {"x": 0.25, "z": 1.1, "yaw": 0.5,
                             "base_frame_id": "base_link"},
    "prefiltering_component": {
        "downsample_resolution": 0.3, "outlier_removal_method": "RADIUS",
        "radius_radius": 0.7, "capacity_raw_points": 4096,
        "enable_deskewing": True, "points_topic": "/velodyne_points"},
    "scan_matching_odometry_component": {
        "keyframe_delta_translation": 1.5, "max_acceptable_angle": 0.4,
        "registration_method": "SMALL_GICP", "reg_maximum_iterations": 20,
        "reg_covariance_mode": "knn", "odom_frame_id": "odom"},
    "floor_detection_component": {
        "enable_floor_detection": True, "sensor_height": 1.8,
        "floor_pts_thresh": 256, "tilt_deg": 2.0},
    "mrg_slam_component": {
        "own_name": "husky7", "multi_robot_names": ["husky7", "husky8"],
        "init_pose": [1.0, -2.0, 0.0, 0.3, 0.0, 0.0],
        "keyframe_delta_trans": 1.25, "capacity_keyframes": 96,
        "solver_backend": "chain", "g2o_solver_num_iterations": 48,
        "candidate_max_xy_distance": 12.0, "capacity_candidates": 6,
        "use_const_inf_matrix": True, "const_stddev_x": 0.3,
        "reg_maximum_iterations": 24, "reg_coarse_stride": 2,
        "enable_gps": True, "gps_edge_stddev_xy": 3.0,
        "enable_imu_orientation": True, "enable_floor_coeffs": False,
        "graph_request_min_accum_dist": 1.5,
        "fitness_score_thresh": 0.4,
        "not_a_field": 17, "map_frame_id": "map"},
}


def _yaml(nested: bool) -> dict:
    """The YAML above as a dict, each section nested under
    ros__parameters or flat; the other layout in odd sections when
    `nested` is None."""
    out = {}
    for i, (name, params) in enumerate(_SECTIONS.items()):
        wrap = (i % 2 == 0) if nested is None else nested
        out[name] = ({"ros__parameters": dict(params)} if wrap
                     else dict(params))
    # a round trip through the YAML text, as the CLI reads a file
    return yaml.safe_load(yaml.safe_dump(out))


def _asdict_equal(jc, tc):
    a, b = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert a == b
    # and the same types on both sides (tuple vs list, int vs float)
    for key in a:
        assert type(a[key]) is type(b[key]), key


@pytest.mark.parametrize("nested", [True, False, None],
                         ids=["ros__parameters", "flat", "mixed"])
def test_from_yaml_dict_matches_the_jax_package(nested):
    d = _yaml(nested)
    jc = JEngineConfig.from_yaml_dict(copy.deepcopy(d))
    tc = TEngineConfig.from_yaml_dict(copy.deepcopy(d))
    _asdict_equal(jc, tc)
    assert tc.model_namespace == "husky7"
    assert tc.slam.multi_robot_names == ("husky7", "husky8")
    assert tc.slam.init_pose == [1.0, -2.0, 0.0, 0.3, 0.0, 0.0]
    assert tc.slam.optimizer.solver_backend == "chain"
    assert tc.slam.loop.capacity_candidates == 6
    # the odometry's registration and the back end's come from their own
    # sections
    assert tc.odometry.registration.reg_maximum_iterations == 20
    assert tc.slam.registration.reg_maximum_iterations == 24
    # a key two back-end dataclasses declare fills both
    assert tc.slam.loop.fitness_score_thresh == 0.4
    assert tc.slam.inf_matrix.fitness_score_thresh == 0.4
    assert tc.floor.enable_floor_detection
    assert tc.lidar2base.yaw == 0.5


def test_empty_and_partial_yaml_give_the_defaults():
    for d in ({}, {"mrg_slam_component": None},
              {"/**": {"ros__parameters": {}}}):
        _asdict_equal(JEngineConfig.from_yaml_dict(copy.deepcopy(d)),
                      TEngineConfig.from_yaml_dict(copy.deepcopy(d)))
    assert TEngineConfig.from_yaml_dict({}) == TEngineConfig()
    tc = TEngineConfig().with_overrides(model_namespace="x")
    assert tc.model_namespace == "x" and tc.slam == TEngineConfig().slam


_TOKENS = ["keyframe_delta_trans:=1.1", "capacity_keyframes:=128",
           "own_name:=bestla", "multi_robot_names:=[\"atlas\", \"bestla\"]",
           "enable_gps:=true", "downsample_resolution:=0.25",
           "registration_method:=SMALL_GICP", "solver_backend:=dense",
           "reg_maximum_iterations:=18", "tilt_deg:=1e-1",
           "result_dir:=/tmp/run:1", "model_namespace:=bestla"]


def test_parse_overrides_matches_the_jax_package():
    j = jlaunch._parse_overrides(_TOKENS)
    t = tlaunch._parse_overrides(_TOKENS)
    assert t == j
    assert {k: type(v) for k, v in t.items()} == {
        k: type(v) for k, v in j.items()}
    assert t["capacity_keyframes"] == 128 and t["enable_gps"] is True
    assert t["result_dir"] == "/tmp/run:1"  # split at the first ":="
    with pytest.raises(SystemExit):
        tlaunch._parse_overrides(["keyframe_delta_trans=1.1"])


@pytest.mark.parametrize("nested", [True, False, None],
                         ids=["ros__parameters", "flat", "no file"])
def test_apply_overrides_matches_the_jax_package(nested):
    d = {} if nested is None else _yaml(nested)
    ov = tlaunch._parse_overrides(_TOKENS)
    jd = jlaunch._apply_overrides(copy.deepcopy(d), dict(ov))
    td = tlaunch._apply_overrides(copy.deepcopy(d), dict(ov))
    assert td == jd
    jc = JEngineConfig.from_yaml_dict(jd)
    tc = TEngineConfig.from_yaml_dict(td)
    _asdict_equal(jc, tc)
    # one flat namespace: each override lands in every dataclass that
    # declares it
    assert tc.slam.keyframe_delta_trans == 1.1
    assert tc.slam.own_name == "bestla"
    assert tc.slam.multi_robot_names == ("atlas", "bestla")
    assert tc.prefilter.downsample_resolution == 0.25
    assert tc.odometry.registration.reg_maximum_iterations == 18
    assert tc.slam.registration.reg_maximum_iterations == 18
    assert tc.floor.tilt_deg == 0.1
    # `model_namespace` comes from `/**` only, as the JAX package reads it
    assert tc.model_namespace == ("husky7" if nested is not None
                                  else "atlas")
