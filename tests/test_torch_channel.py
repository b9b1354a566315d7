"""The port's transport (parallel/channel.py) and the wire form of a delta
graph on it: twins of the JAX package's tests/test_aux_components.py
bus and socket tests, the graph exchange over a socket in the wire form
(host numpy, no torch class in the pickled payload), and
`quantize_graph_msg`'s one device->host read a message.

The wire form's bytes are held to the per-cloud `quantize_cloud` result
exactly: both quantize the same float32 values with the same numpy.
"""

import dataclasses
import io
import pickle
import time

import numpy as np
import pytest
import torch

from mrg_slam_tpu_torch.config import OptimizerConfig, SlamConfig
from mrg_slam_tpu_torch.models.backend import MrgSlam
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.parallel import messages
from mrg_slam_tpu_torch.parallel.channel import (InProcessBus, SocketClient,
                                                 SocketServer)


def test_in_process_bus():
    bus = InProcessBus()
    got = []
    bus.subscribe("t", got.append)
    bus.publish("t", 42)
    assert got == [42]
    bus.advertise("svc", lambda x: x * 2)
    assert bus.call("svc", 21) == 42
    assert bus.call("missing", 0) is None


def test_in_process_bus_timeout_honored():
    """A slow service returns None at the timeout instead of blocking the
    caller, as SocketClient does; timeout=None calls inline."""
    bus = InProcessBus()
    bus.advertise("slow", lambda req: (time.sleep(0.8), "late")[1])
    t0 = time.perf_counter()
    assert bus.call("slow", None, timeout=0.1) is None
    assert time.perf_counter() - t0 < 0.6
    bus.advertise("fast", lambda req: req + 1)
    assert bus.call("fast", 1) == 2
    assert bus.call("fast", 1, timeout=None) == 2
    assert bus.call("missing", 1) is None


def test_socket_channel_roundtrip():
    srv = SocketServer()
    srv.advertise("echo", lambda req: {"got": req, "arr": np.arange(5)})
    cli = SocketClient(srv.address, timeout=5.0)
    try:
        out = cli.call("echo", {"hello": np.ones(3, np.float32)})
        assert out["got"]["hello"].sum() == 3.0
        np.testing.assert_array_equal(out["arr"], np.arange(5))
        assert cli.call("nope", 1) is None
    finally:
        cli.close()
        srv.close()


def _pickled_modules(blob):
    """The modules of every class a pickle refers to; raises on one of
    torch's."""
    seen = set()

    class Reader(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] == "torch":
                raise AssertionError(f"torch class in the payload: "
                                     f"{module}.{name}")
            seen.add(module)
            return super().find_class(module, name)

    Reader(io.BytesIO(blob)).load()
    return seen


def _slam(name):
    return MrgSlam(SlamConfig(
        own_name=name, multi_robot_names=("alpha", "beta"),
        capacity_keyframes=32, capacity_edges=64,
        capacity_keyframe_points=64,
        optimizer=OptimizerConfig(solver_backend="dense"),
        exchange=dataclasses.replace(
            SlamConfig().exchange, graph_request_min_time_delay=0.0,
            graph_request_min_accum_dist=0.0)), device="cpu")


def test_graph_exchange_over_sockets():
    """Robot B serves publish_graph behind a SocketServer in the wire form
    (what multiprocess.py's workers send); robot A pulls it through a
    client and dequantizes it onto its own device."""
    rng = np.random.default_rng(2)
    a, b = _slam("alpha"), _slam("beta")
    for i in range(4):
        pts = rng.normal(size=(32, 3)).astype(np.float32)
        pose = np.asarray([i * 2.0, 0, 0, 1, 0, 0, 0], np.float32)
        a.process_scan(i * 0.5, pose, PointCloud.from_array(
            pts, capacity=64, device="cpu"))
        b.process_scan(i * 0.5, pose + np.asarray([0, 1, 0, 0, 0, 0, 0],
                                                  np.float32),
                       PointCloud.from_array(pts, capacity=64, device="cpu"))
    a.optimization_tick(now=2.0)
    b.optimization_tick(now=2.0)

    sent = []

    def publish_graph(req):
        wire = messages.quantize_graph_msg(b.handle_publish_graph(req))
        sent.append(pickle.dumps(wire))
        return wire

    srv = SocketServer()
    srv.advertise("publish_graph", publish_graph)
    cli = SocketClient(srv.address, timeout=10.0)
    try:
        def request_fn(peer_name, req):
            wire = cli.call("publish_graph", req)
            return messages.dequantize_graph_msg(wire, "cpu")

        sp = b.slam_pose_broadcast(2.0)
        assert sp is not None
        assert a.on_slam_pose_broadcast(sp, now=2.0, request_fn=request_fn)
    finally:
        cli.close()
        srv.close()
    # the payload is host data only: no tensor, no class of torch (the
    # port's own module name holds the word, so the pickle's class
    # references are read, not its bytes)
    assert len(sent) == 1
    mods = _pickled_modules(sent[0])
    assert "mrg_slam_tpu_torch.parallel.messages" in mods
    assert {m.split(".")[0] for m in mods} <= {"mrg_slam_tpu_torch",
                                                "numpy", "builtins"}
    assert a.received_graph_bytes[-1] == pickle.loads(sent[0]).wire_nbytes
    a.optimization_tick(now=3.0)
    merged = [k for k in a.db.keyframes + a.db.new_keyframes
              if k.robot_name == "beta"]
    assert len(merged) >= 3
    assert all(k.cloud.points.device.type == "cpu" for k in merged)


def test_quantize_graph_msg_reads_the_card_once(monkeypatch):
    """One device->host copy for a message of K clouds of mixed
    capacities, with the bytes of the per-cloud wire form."""
    rng = np.random.default_rng(4)
    clouds = [PointCloud.from_array(
        rng.uniform(-30, 30, (n, 3)).astype(np.float32), capacity=c,
        device="cpu") for n, c in ((100, 128), (0, 64), (1000, 1024),
                                   (7, 7))]
    kfs = [messages.KeyFrameMsg(
        robot_name="beta", uuid=f"k{i}", slam_uuid="s", stamp=float(i),
        odom_counter=i, first_keyframe=i == 0, static_keyframe=False,
        accum_distance=float(i), estimate=np.zeros(7, np.float32), cloud=c)
        for i, c in enumerate(clouds)]
    msg = messages.GraphMsg(robot_name="beta", latest_keyframe_uuid="k3",
                            latest_keyframe_odom=np.zeros(7, np.float32),
                            keyframes=kfs, edges=[])
    calls = []
    cpu = torch.Tensor.cpu

    def counted(t, *a, **kw):
        calls.append(tuple(t.shape))
        return cpu(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    wire = messages.quantize_graph_msg(msg)
    assert len(calls) == 1
    monkeypatch.undo()
    for k, c in zip(wire.keyframes, clouds):
        want = messages.quantize_cloud(c)
        assert k.cloud.offsets.dtype == np.uint16
        assert k.cloud.offsets.tobytes() == want.offsets.tobytes()
        assert k.cloud.origin.tobytes() == want.origin.tobytes()
        assert (k.cloud.scale, k.cloud.capacity) == (want.scale,
                                                     want.capacity)
    assert wire.wire_nbytes == wire.nbytes() > 0
    # a message with no cloud left to quantize reads nothing
    calls.clear()
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    again = messages.quantize_graph_msg(wire)
    assert calls == [] and again.wire_nbytes == wire.wire_nbytes
