"""The port's program spans (utils/profiling.py) on the CPU: off, a span is
one shared object that records nothing; on, nesting gives parents, self
times and ids; under torch.profiler a span is a `slam.<name>` range on
the profiler's clock; and a small block of odometry plus one tick
records one `read.lm_iteration` an LM iteration and one
`read.pair_bucket` a pair bucket."""

import threading
import time

import numpy as np
import pytest
import torch

from mrg_slam_tpu_torch.config import (OptimizerConfig, PrefilterConfig,
                                       RegistrationConfig,
                                       ScanMatchingOdometryConfig,
                                       SlamConfig)
from mrg_slam_tpu_torch.io.synthetic import SyntheticWorld, circle_trajectory
from mrg_slam_tpu_torch.models import odometry_fused as fused
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.ops.prefilter import prefilter
from mrg_slam_tpu_torch.utils import profiling


@pytest.fixture
def spans():
    profiling.reset()
    profiling.enable(True)
    try:
        yield profiling
    finally:
        profiling.enable(False)
        profiling.reset()


def test_off_span_is_the_shared_null_and_records_nothing():
    profiling.reset()
    assert profiling.span("lm") is profiling.OFF
    assert profiling.request("tick") is profiling.OFF
    with profiling.span("lm"):
        with profiling.span("lm.iteration"):
            pass
    assert profiling.records() == [] and profiling.summary() == {}


def test_nesting_gives_parents_self_times_and_ids(spans):
    with spans.request("tick"):
        with spans.span("lm"):
            time.sleep(0.002)
            with spans.span("lm.iteration"):
                with spans.span("read.lm_iteration"):
                    time.sleep(0.003)
    with spans.request("frame"):
        with spans.span("tick.post"):
            pass
    with spans.span("read.odom_gn"):
        pass
    recs = {r.name: r for r in spans.records()}
    assert [r.name for r in spans.records()] == [
        "read.lm_iteration", "lm.iteration", "lm", "tick.post",
        "read.odom_gn"]
    assert recs["lm"].parent is None
    assert recs["lm.iteration"].parent == "lm"
    assert recs["read.lm_iteration"].parent == "lm.iteration"
    # the open request's id reaches nested spans; none is open at the end
    tick = recs["lm"].id
    assert tick[0] == "tick" and recs["tick.post"].id[0] == "frame"
    assert [recs[n].id for n in ("lm.iteration", "read.lm_iteration",
                                 "read.odom_gn")] == [tick, tick, None]
    assert {r.thread for r in spans.records()} == {threading.get_ident()}
    lm, it, rd = recs["lm"], recs["lm.iteration"], recs["read.lm_iteration"]
    assert lm.self_ns == lm.dur_ns - it.dur_ns
    assert it.self_ns == it.dur_ns - rd.dur_ns
    assert rd.self_ns == rd.dur_ns >= 3e6
    assert lm.self_ns >= 2e6
    assert lm.start_ns <= it.start_ns <= rd.start_ns
    s = spans.summary()
    assert set(s["lm"]) == {"count", "total_us", "avg_us", "max_us",
                            "self_us"}
    assert s["lm"]["count"] == 1
    assert s["lm"]["total_us"] == pytest.approx(lm.dur_ns / 1e3)
    assert s["lm"]["self_us"] == pytest.approx(lm.self_ns / 1e3)
    spans.reset()
    assert spans.records() == []


def test_span_is_a_profiler_range_on_the_profilers_clock(spans):
    from torch.profiler import ProfilerActivity, profile

    x = torch.arange(64, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with spans.span("lm"):
            (x * 2).sum()
        t1 = time.time_ns()
    (rec,) = spans.records()
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "slam.lm"]
    assert len(ranges) == 1
    # both starts fall inside the span's bracket on time.time_ns(), to
    # within 1 ms (perf_counter_ns reads ~1e12 there, the epoch ~1.8e18)
    for start in (ranges[0].start_ns(), rec.start_ns):
        assert t0 - 1e6 < start < t1 + 1e6
    assert abs(ranges[0].start_ns() - rec.start_ns) < (t1 - t0) + 1e6
    # no profiler: no range is opened
    with spans.span("lm") as s:
        assert s.rf is None


def _tiny_run(block: int = 8, ticks: int = 2):
    """Blocks of the synthetic world's circle through prefilter,
    run_batch, process_scan and optimization_tick on the CPU -> the
    ticks' stats and the spans each tick recorded."""
    reg = RegistrationConfig(reg_transformation_epsilon=1e-3,
                             reg_maximum_iterations=16)
    pre = PrefilterConfig(downsample_resolution=0.4,
                          capacity_raw_points=2048,
                          capacity_filtered_points=512,
                          outlier_removal_method="NONE")
    odo = ScanMatchingOdometryConfig(keyframe_delta_translation=1.0,
                                     registration=reg)
    slam = MrgSlam(SlamConfig(
        own_name="a", multi_robot_names=("a",), keyframe_delta_trans=1.0,
        capacity_keyframes=32, capacity_edges=128,
        capacity_keyframe_points=512, registration=reg,
        optimizer=OptimizerConfig(solver_backend="dense",
                                  g2o_solver_num_iterations=8)),
        device="cpu")
    world = SyntheticWorld.build(seed=11, extent=10.0, n_ground=6000,
                                 max_points_per_scan=2048, noise=0.02)
    traj = circle_trajectory(block * ticks, radius=4.0, laps=0.8)
    carry = fused.init_carry(512, device="cpu")
    out = []
    for b in range(ticks):
        raw = [PointCloud.from_array(world.scan(p, seed=i), 2048, "cpu")
               for i, p in enumerate(traj[b * block:(b + 1) * block])]
        c = prefilter(PointCloud(torch.stack([r.points for r in raw]),
                                 torch.stack([r.mask for r in raw])), pre)
        stamps = torch.arange(b * block, (b + 1) * block,
                              dtype=torch.float32) * 0.1
        carry, outs = fused.run_batch(odo, carry, c.points, c.mask, stamps)
        poses = outs.pose.numpy()
        for i in range(block):
            slam.process_scan(float(stamps[i]), poses[i],
                              PointCloud(c.points[i], c.mask[i]))
        profiling.reset()
        st = slam.optimization_tick(now=float(stamps[-1]))
        out.append((st, profiling.records()))
    return out


def test_a_tick_records_one_read_an_lm_iteration_and_a_pair_bucket(spans):
    runs = [(st, recs) for st, recs in _tiny_run() if st is not None]
    assert runs
    ids = []
    for st, recs in runs:
        names = [r.name for r in recs]
        assert names.count("read.lm_iteration") == st.iterations > 0
        assert names.count("lm.iteration") == st.iterations
        assert names.count("read.pair_bucket") == len(st.pair_buckets)
        assert names.count("pairs.bucket") == len(st.pair_buckets)
        assert names.count("lm") == names.count("graph.marginals") == 1
        assert names.count("read.graph_packed") == 1
        for stage in ("tick.flush", "tick.prefetch", "loops.build",
                      "tick.post"):
            assert names.count(stage) == 1, stage
        # every span of the tick carries the tick's id
        (tick,) = {r.id for r in recs}
        assert tick[0] == "tick"
        ids.append(tick)
        parents = {r.name: r.parent for r in recs}
        assert parents["read.lm_iteration"] == "lm.iteration"
        assert parents["lm.iteration"] == "lm"
        assert parents["read.pair_bucket"] == "pairs.bucket"
    assert len(set(ids)) == len(ids)


def test_odometry_records_a_read_a_gauss_newton_iteration(spans):
    """run_batch's per-frame solves read once an iteration; run_batch_multi
    once a sweep of its rows."""
    reg = RegistrationConfig(reg_transformation_epsilon=1e-3,
                             reg_maximum_iterations=6)
    odo = ScanMatchingOdometryConfig(registration=reg)
    world = SyntheticWorld.build(seed=5, extent=10.0, n_ground=4000,
                                 max_points_per_scan=512, noise=0.02)
    traj = circle_trajectory(6, radius=4.0, laps=0.2)
    raw = [PointCloud.from_array(world.scan(p, seed=i), 512, "cpu")
           for i, p in enumerate(traj)]
    pts = torch.stack([r.points for r in raw])
    msk = torch.stack([r.mask for r in raw])
    stamps = torch.arange(6, dtype=torch.float32) * 0.1
    _, outs = fused.run_batch(odo, fused.init_carry(512, "cpu"), pts, msk,
                              stamps)
    reads = [r for r in profiling.records() if r.name == "read.odom_gn"]
    assert len(reads) == int(outs.iterations.sum())
    # each frame's reads carry its id: as many as its GN iterations
    frames = sorted({r.id for r in reads}, key=lambda i: i[1])
    assert [k for k, _ in frames] == ["frame"] * 6
    assert [sum(r.id == i for r in reads) for i in frames] == \
        outs.iterations.tolist()
    profiling.reset()
    carries = fused.stack_carries([fused.init_carry(512, "cpu")] * 2)
    _, outs = fused.run_batch_multi(odo, carries, pts.view(2, 3, 512, 3),
                                    msk.view(2, 3, 512),
                                    stamps.view(2, 3))
    names = [r.name for r in profiling.records()]
    # one read a sweep: as many sweeps as the slowest row's iterations
    it = outs.iterations.numpy()
    assert names.count("read.rows_sweep") == int(np.max(it, axis=0).sum())


# -- tools/profile_spans.py's reduction of a profiler trace by program span --

def _tool():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "profile_spans.py"
    spec = importlib.util.spec_from_file_location("profile_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ev:
    """A stand-in for a profiler's raw event (times in ns)."""

    def __init__(self, name, a, b, dev=False, corr=0, linked=0, thread=1):
        self._v = (name, a, b, dev, corr, linked, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return "cuda" if self._v[3] else "cpu"

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _events(program: bool):
    """A tick whose LM iteration launches a kernel and, inside its read, a
    copy; a kernel launched in the tick outside any program span; with
    `program`, the `slam.*` ranges and their GPU-side shadows."""
    ev = [_Ev("bench.window", 0, 1000), _Ev("bench.tick", 100, 900),
          _Ev("cudaLaunchKernel", 260, 262, corr=11),
          _Ev("kernel_a", 270, 300, dev=True, linked=11),
          _Ev("cudaMemcpyAsync", 510, 512, corr=12),
          _Ev("Memcpy DtoH", 520, 530, dev=True, linked=12),
          _Ev("cudaLaunchKernel", 150, 152, corr=13),
          _Ev("kernel_b", 700, 750, dev=True, linked=13)]
    if program:
        ev += [_Ev("slam.lm", 200, 600), _Ev("slam.lm.iteration", 250, 550),
               _Ev("slam.read.lm_iteration", 500, 540),
               _Ev("slam.lm", 270, 600, dev=True),
               _Ev("slam.lm.iteration", 270, 550, dev=True),
               # another thread's range is not the driving thread's
               _Ev("slam.tick.post", 690, 760, thread=2)]
    return ev


def test_program_spans_and_their_shadows_leave_the_device_numbers_alone():
    from benchmark import trace as benchtrace

    tool = _tool()
    plain = benchtrace.reduce_kineto(_events(False), "cuda")
    for program in (False, True):
        red = tool.reduce_program_spans(_events(program), "cuda")
        assert red["busy_s"] == pytest.approx(plain["busy_s"])
        assert red["window_s"] == pytest.approx(plain["window_s"])
        assert red["layer_device_s"] == pytest.approx(plain["layer_device_s"])
        assert red["idle_by_layer"] == pytest.approx(plain["idle_by_layer"])
        assert red["device_events"] == plain["device_events"] == 3
    assert plain["busy_s"] == pytest.approx(90e-9)


def test_device_ops_go_to_the_innermost_program_span_at_their_launch():
    tool = _tool()
    red = tool.reduce_program_spans(_events(True), "cuda")
    sp = red["spans"]
    ns = 1e-9
    assert sp["lm.iteration"]["device_s"] == pytest.approx(30 * ns)
    assert sp["read.lm_iteration"]["device_s"] == pytest.approx(10 * ns)
    assert sp["-"]["device_s"] == pytest.approx(50 * ns)
    assert "device_s" not in sp["lm"]  # nothing launched in lm alone
    assert sp["lm"]["device_incl_s"] == pytest.approx(40 * ns)
    assert sp["lm"]["ops_incl"] == sp["lm.iteration"]["ops_incl"] == 2
    assert sp["lm.iteration"]["ranges"] == sp["tick.post"]["ranges"] == 1
    # gaps (0, 270), (300, 520), (530, 700), (750, 1000), each labelled
    # by the layer and the program span open at its midpoint
    assert sp["lm.iteration"]["idle_s"] == pytest.approx(220 * ns)
    assert red["idle_by_label"] == pytest.approx(
        {"tick/lm.iteration": 220 * ns, "tick": (270 + 170 + 250) * ns})
    assert red["idle_gaps"][0] == ["tick", pytest.approx(270 * ns)]
    m = tool.per_frame(red, frames=2)
    assert m["lm_device_ms_per_frame"] == pytest.approx(40 * ns / 2 * 1e3)
    assert m["pairs_device_ms_per_frame"] == 0.0
    assert m["lm_device_ops_per_iteration"] == 2
    assert m["tick_device_ms_per_frame"] == pytest.approx(90 * ns / 2 * 1e3)


def test_window_breakdown_by_parent_tick_and_frame():
    tool = _tool()
    S = profiling.Span
    recs = [S("read.odom_gn", 0, 10, 10, None, 1, ("frame", 0)),
            S("read.odom_gn", 0, 10, 10, None, 1, ("frame", 0)),
            S("read.odom_gn", 0, 10, 10, None, 1, ("frame", 1)),
            S("read.rows_sweep", 0, 10, 10, "pairs.bucket", 1, ("tick", 0)),
            S("pairs.bucket", 0, 2e6, 2e6, None, 1, ("tick", 0)),
            S("lm", 0, 3e6, 3e6, None, 1, ("tick", 0)),
            S("lm", 0, 7e6, 7e6, None, 2, ("tick", 1))]
    out = tool.by_request(recs)
    assert out["tick_ms"] == {"median_ms": 6.0, "max_ms": 7.0}
    assert out["reads_by_parent"] == {"read.odom_gn in -": 3,
                                      "read.rows_sweep in pairs.bucket": 1}
    assert out["ticks"] == 2 and out["threads"] == 2
    assert out["tick_ms_by_span"]["lm"] == {"median_ms": 5.0, "max_ms": 7.0}
    assert out["tick_ms_by_span"]["pairs.bucket"]["max_ms"] == 2.0
    assert out["reads_per_odometry_frame"] == {"median": 1.5, "max": 2}
