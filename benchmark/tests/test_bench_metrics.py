"""The metric arithmetic: the idle share's union, the rate over the whole
window, the roofline reckoning on fixed shapes, and the readers."""

import types

import pytest

from benchmark import peaks, trace
from benchmark.run import reader


def test_union_merges_overlaps_and_clips():
    busy, gaps = trace.union([(1.0, 3.0), (2.0, 4.0), (6.0, 7.0),
                              (-1.0, 0.5), (9.5, 12.0)], 0.0, 10.0)
    assert busy == pytest.approx(0.5 + 3.0 + 1.0 + 0.5)
    assert gaps == [(0.5, 1.0), (4.0, 6.0), (7.0, 9.5)]


def test_union_of_nothing_is_one_gap():
    assert trace.union([], 2.0, 5.0) == (0.0, [(2.0, 5.0)])


def test_idle_share_is_one_minus_busy_over_window():
    rec = types.SimpleNamespace(trace={"busy_s": 1.5, "window_s": 6.0})
    assert reader("device_idle_share").read(rec) == pytest.approx(75.0)
    assert reader("device_idle_share").read(
        types.SimpleNamespace(trace=None)) is None


def test_roofline_of_one_frame_by_hand():
    # moments: 9 * 1000^2 ops = 9e6 -> 1.343e-7 s; bytes 52e3 -> 1.55e-8 s
    # nn: 9 * 1000 * 800 * 3 iterations = 2.16e7 ops -> 3.224e-7 s
    want = 9e6 / 67e12 + 3 * max(9 * 1000 * 800 / 67e12,
                                 (1800 * 12 + 12000) / 3.35e12)
    assert peaks.odometry_frame_s(1000, 800, 3) == pytest.approx(want)
    # no keyframe yet: the moments alone
    assert peaks.odometry_frame_s(1000, 0, 5) == pytest.approx(9e6 / 67e12)


def test_roofline_reader_is_bound_over_device_time():
    rec = types.SimpleNamespace(
        odometry_bound_s=0.2,
        trace={"layer_device_s": {"odometry": 0.8}})
    assert reader("odometry_roofline").read(rec) == pytest.approx(25.0)
    rec.trace = {"layer_device_s": {}}
    assert reader("odometry_roofline").read(rec) is None


def test_per_frame_and_per_tick_readers():
    ticks = [types.SimpleNamespace(loop_closure_us=2000.0,
                                   optimization_us=500.0),
             types.SimpleNamespace(loop_closure_us=4000.0,
                                   optimization_us=1500.0)]
    rec = types.SimpleNamespace(
        frames=50, ticks=ticks, gn_iterations=300, trace_frames=25,
        wall_s={"odometry": 1.0, "ingest": 0.1},
        trace={"layer_device_s": {"prefilter": 0.025}})
    assert reader("odometry_ms_per_frame").read(rec) == pytest.approx(20.0)
    assert reader("ingest_ms_per_frame").read(rec) == pytest.approx(2.0)
    assert reader("prefilter_ms_per_frame").read(rec) == pytest.approx(1.0)
    assert reader("gn_iterations_per_frame").read(rec) == pytest.approx(6.0)
    assert reader("loop_closure_ms_per_tick").read(rec) == pytest.approx(3.0)
    assert reader("optimize_ms_per_tick").read(rec) == pytest.approx(1.0)
    rec.ticks = []
    assert reader("optimize_ms_per_tick").read(rec) is None


def test_device_time_and_host_paced_readers():
    rec = types.SimpleNamespace(
        frames=120, window_s=4.0, trace_frames=50,
        trace={"layer_device_s": {"odometry": 0.2, "tick": 0.35}})
    assert reader("frames_per_s.host_paced").read(rec) == pytest.approx(30.0)
    assert reader("odometry_device_ms_per_frame").read(rec) == \
        pytest.approx(4.0)
    assert reader("tick_device_ms_per_frame").read(rec) == pytest.approx(7.0)
    rec.trace = None
    assert reader("tick_device_ms_per_frame").read(rec) is None
    rec.frames = 0
    assert reader("frames_per_s.host_paced").read(rec) is None


@pytest.mark.parametrize("name", ["prefilter_ms_per_frame",
                                  "gn_iterations_per_frame",
                                  "odometry_roofline"])
def test_card_readers_read_as_their_originals(name):
    rec = types.SimpleNamespace(
        frames=50, gn_iterations=300, trace_frames=25, odometry_bound_s=0.2,
        trace={"layer_device_s": {"prefilter": 0.025, "odometry": 0.8}})
    want = reader(name).read(rec)
    assert want is not None
    assert reader(name + ".card").read(rec) == pytest.approx(want)
    assert reader(name + ".card").UNIT == reader(name).UNIT


class _FakeSystem:
    """Blocks that take a fixed time each."""

    def __init__(self, step):
        self.device, self.step, self.blocks = "cpu", step, 0

    def start(self, episode, windows):
        return types.SimpleNamespace(episode=episode, blocks=0)

    def block(self, run, spans):
        import time
        time.sleep(self.step)
        run.blocks += 1
        self.blocks += 1


def test_window_closes_at_the_first_block_boundary_after_seconds():
    from benchmark.run import window
    ep = types.SimpleNamespace(rows=types.SimpleNamespace(shape=(3, 4)))
    fake = _FakeSystem(0.02)
    runs, wall, ends = window(fake, [ep, ep], None, 0.1, None)
    # whole blocks only, episodes back to back, the rate over all of it
    assert fake.blocks == sum(r.blocks for r in runs)
    assert wall >= 0.1 and fake.blocks >= 5
    assert [r.blocks for r in runs[:-1]] == [3] * (len(runs) - 1)
    assert len(ends) == len(runs) and ends == sorted(ends)
    assert ends[-1] <= wall


class _Ev:
    """A raw profiler event as `reduce_kineto` reads one."""

    def __init__(self, name, dev, a, b, corr=0, linked=0):
        self._v = (name, dev, a, b, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_trace_reduction_attributes_device_time_by_launch():
    cpu, gpu = "cpu", "gpu"
    s = 1_000_000_000  # ns a second
    ev = [_Ev("bench.window", cpu, 0, 10 * s),
          _Ev("bench.window", gpu, 0, 10 * s),      # its device shadow
          _Ev("bench.prefilter", cpu, 0, 2 * s),
          _Ev("bench.odometry", cpu, 2 * s, 6 * s),
          _Ev("aten::mul", cpu, 1 * s, 1 * s + 5, corr=7),
          _Ev("aten::add", cpu, 3 * s, 3 * s + 5, corr=8),
          # launched in the prefilter, run while the host is in odometry
          _Ev("k_mul", gpu, 2 * s, 3 * s, linked=7),
          _Ev("k_add", gpu, 3 * s, 4 * s, linked=8),
          # no launching op: its own start decides
          _Ev("k_raw", gpu, int(3.5 * s), 5 * s)]
    r = trace.reduce_kineto(ev, gpu)
    assert r["window_s"] == pytest.approx(10.0)
    assert r["busy_s"] == pytest.approx(3.0)
    assert r["layer_device_s"] == pytest.approx(
        {"prefilter": 1.0, "odometry": 2.5})
    assert r["device_ops"][0] == ["k_raw", pytest.approx(1.5)]
    # gaps 0-2 s and 5-10 s, each named by where the host was at its middle
    assert r["idle_by_layer"] == pytest.approx(
        {"prefilter": 2.0, "harness": 5.0})
    assert r["idle_gaps"] == [["harness", pytest.approx(5.0)],
                              ["prefilter", pytest.approx(2.0)]]
    assert trace.reduce_kineto(ev[2:], gpu) is None
