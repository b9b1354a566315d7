"""Process-isolated multi-robot deployment: one OS process per robot,
delta-graph exchange over real TCP.

Counterpart of the JAX package's pipeline/multiprocess.py, the
reference's deployment topology: one SLAM process per robot
(launch/mrg_slam.launch.py:212-221; kitti_multirobot_processor.py:85-117
spawns them via subprocess), peers exchanging delta graphs through the
PublishGraph service with a 20 s timeout
(apps/mrg_slam_component.cpp:617-625). Each robot process runs the full
stack (pipeline/replay.Robot) and serves three endpoints over
parallel/channel.SocketServer:

- "publish_graph": delta-graph request/response. Responses ship clouds in
  the quantized wire form (uint16 voxel offsets and a scale, host numpy,
  parallel/messages.quantize_graph_msg), ~4x fewer bytes than the
  reference's float clouds; the requester dequantizes them onto its own
  device. A device tensor never crosses the socket: it would unpickle
  onto the peer's device.
- "odom" / "slam_pose": one-way PoseWithName broadcasts, queued and
  drained by the receiving robot's main loop (the reference takes
  main_thread_mutex for the same races, mrg_slam_component.cpp:1369-1425).

Each robot process opens its own CUDA context on the card (several
contexts time-slice one card; the JAX package ran its workers on CPU JAX,
as two processes cannot share a TPU). The device is chosen in the parent
and passed to every worker, so a worker never falls back to the CPU; on
the card the parent builds the kernels once before spawning, and the
workers load the libraries.

All torch work runs on each robot's main thread: the socket handler
threads only queue work (publish_graph requests to `pending`, broadcasts
to the inbox), and the main loop serves them at its service points. CUDA
work from a handler thread would interleave with the main thread's solve
on the default stream. Requests wait a frame or two, far under the 20 s
service timeout, and two robots requesting each other's graphs at once
cannot deadlock (`call_serving`).

CLI:
    python -m mrg_slam_tpu_torch.pipeline.multiprocess --robots 2 \
        --frames 80 --out /tmp/mp_run [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..runtime import DeviceLike, resolve_device

# what a worker's fresh interpreter runs: its job arrives pickled on stdin
WORKER_IMPORT = ("from mrg_slam_tpu_torch.pipeline.multiprocess import "
                 "_worker_main")
BOOTSTRAP = (f"import sys; {WORKER_IMPORT}; "
             "_worker_main(sys.stdin.buffer.read())")
NAMES = ("alpha", "bravo", "charlie", "delta")


def _worker_main(arg_blob: bytes) -> None:
    """Robot subprocess entry, given its pickled job dict (a plain dict,
    not the dataclass, so that a `python -m` parent pickles nothing the
    worker cannot resolve)."""
    import types

    import torch

    job = types.SimpleNamespace(**pickle.loads(arg_blob))
    device = resolve_device(job.device)

    from ..io.synthetic import SyntheticWorld, circle_trajectory
    from ..ops import nn_kernel, stats_kernel
    from ..parallel.channel import SocketClient, SocketServer
    from ..parallel.messages import dequantize_graph_msg, quantize_graph_msg
    from ..utils.metrics import ate_rmse
    from ..utils.profiling import SyncAudit
    from ..utils.tum import save_tum
    from .replay import Robot

    # the robots share the host's cores: R processes of a torch thread per
    # core each would oversubscribe them R times over, and the threads
    # that spin after each parallel op starve every robot's main thread
    torch.set_num_threads(job.cpu_threads)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    robot = Robot(job.cfg, device=device)
    slam = robot.slam
    inbox: List[Tuple[str, object]] = []
    inbox_lock = threading.Lock()
    reads = SyncAudit(device)
    publish: List[dict] = []

    server = SocketServer(port=job.port)

    # publish_graph is served from the main thread: the handler queues the
    # request and waits on an event that the main loop sets at its next
    # service point (frame boundary, drain, barrier poll)
    pending: List[Tuple[object, threading.Event, dict]] = []
    pending_lock = threading.Lock()

    def publish_graph(req):
        ev, holder = threading.Event(), {}
        with pending_lock:
            pending.append((req, ev, holder))
        # requesters serve their own queue while blocked on us
        # (call_serving), so this only expires if the peer died mid-run,
        # and the requester then fails loudly
        ev.wait(timeout=30.0)
        return holder.get("resp")

    def serve_pending() -> None:
        with pending_lock:
            todo, pending[:] = list(pending), []
        for req, ev, holder in todo:
            r0, t0 = reads.count(), time.perf_counter()
            msg = slam.handle_publish_graph(req)
            wire = quantize_graph_msg(msg)
            if slam.sent_graph_bytes:
                # account what crosses the wire, not the float form
                slam.sent_graph_bytes[-1] = wire.nbytes()
            publish.append(dict(
                keyframes=len(msg.keyframes),
                ms=(time.perf_counter() - t0) * 1e3,
                reads=None if r0 is None else reads.count() - r0))
            holder["resp"] = wire
            ev.set()

    def enqueue(kind):
        def handler(msg):
            with inbox_lock:
                inbox.append((kind, msg))
        return handler

    server.advertise("publish_graph", publish_graph)
    server.advertise("odom", enqueue("odom"))
    server.advertise("slam_pose", enqueue("slam_pose"))
    # lock-step pacing: peers poll our global frame index so free-running
    # processes keep bounded skew (the reference gates playback on peer
    # SlamStatus the same way, kitti_multirobot_processor.py:95-99);
    # 10**9 = window finished, never block on us again. Until its window
    # starts a robot reports the frame before it: the JAX package starts
    # at -1, and then robots whose windows start more than tick_every
    # frames apart wait on each other until wait_for_peers' deadline
    # (60 s a robot at R = 4, 80 frames)
    progress = {"frame": job.window[0] - 1}
    server.advertise("progress", lambda _: progress["frame"])
    final_done = {"done": False}
    server.advertise("final_done", lambda _: final_done["done"])

    # handshake: report our bound port, wait for the peers' addresses
    with open(job.handshake_path, "w") as f:
        json.dump({"name": job.name, "address": list(server.address)}, f)
    peers: Dict[str, SocketClient] = {}
    deadline = time.time() + 60.0
    peer_names = [n for n in job.all_names if n != job.name]
    while time.time() < deadline and len(peers) < len(peer_names):
        for name in peer_names:
            if name in peers:
                continue
            path = os.path.join(job.out_dir, f"{name}.addr")
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        addr = json.load(f)["address"]
                    peers[name] = SocketClient(addr, timeout=20.0)
                except (json.JSONDecodeError, OSError, KeyError):
                    pass
        time.sleep(0.05)
    if len(peers) != len(peer_names):
        raise RuntimeError(f"{job.name}: peers missing: "
                           f"{sorted(set(peer_names) - set(peers))}")

    def call_serving(peer_name: str, endpoint: str, payload):
        """A blocking service call that keeps serving our publish_graph
        queue while the request is in flight: two robots pulling from each
        other at once would otherwise each block inside the other's call
        and both requests expire. The socket wait runs on a helper thread
        (socket I/O only); the main thread serves peers until the answer
        lands."""
        out = {}
        done = threading.Event()

        def runner():
            try:
                out["resp"] = peers[peer_name].call(endpoint, payload)
            finally:
                done.set()

        t = threading.Thread(target=runner, daemon=True)
        t.start()
        while not done.wait(timeout=0.005):
            serve_pending()
        t.join()
        return out.get("resp")

    def request_fn(peer_name: str, req):
        graph = call_serving(peer_name, "publish_graph", req)
        if graph is None:
            # a dropped exchange fails the run: the reference tolerates
            # service timeouts because its robots retry forever
            # (mrg_slam_component.cpp:617-625); a finite run must not
            # pass with nothing merged
            raise RuntimeError(
                f"{job.name}: publish_graph to {peer_name} dropped")
        return dequantize_graph_msg(graph, device)

    def drain(now: float) -> None:
        serve_pending()
        with inbox_lock:
            msgs, inbox[:] = list(inbox), []
        for kind, msg in msgs:
            if kind == "odom":
                slam.on_odom_broadcast(msg)
            else:
                slam.on_slam_pose_broadcast(msg, now=now,
                                            request_fn=request_fn)

    # deterministic frame source: the shared world made again from its seed
    world = SyntheticWorld.build(seed=job.world_seed, extent=30.0,
                                 n_ground=25000, max_points_per_scan=8192,
                                 noise=0.02)
    traj = circle_trajectory(job.total_frames, radius=12.0, laps=1.1)
    lo, hi = job.window

    # Both waits bound a stall, not the whole wait: the deadline starts
    # again whenever a peer's reported progress moves, so a loaded host
    # that slows every robot does not break the lock step, and a peer
    # that stops moving fails the run (ROADMAP §3 B11).
    def wait_for_peers(i: int, max_skew: int, stall_s: float = 60.0) -> None:
        seen, deadline = None, time.time() + stall_s
        while True:
            serve_pending()   # a waiting peer may need our graph to move
            prog = [peers[n].call("progress", None) for n in peer_names]
            if all(p is None or p >= i - max_skew for p in prog):
                return
            if prog != seen:
                seen, deadline = prog, time.time() + stall_s
            elif time.time() > deadline:
                raise RuntimeError(
                    f"{job.name}: peers {dict(zip(peer_names, prog))} did "
                    f"not move for {stall_s:.0f} s before frame {i}")
            time.sleep(0.02)

    def barrier(endpoint, ok, what, stall_s: float = 120.0):
        seen, deadline = None, time.time() + stall_s
        while True:
            serve_pending()
            vals = [call_serving(n, endpoint, None) for n in peer_names]
            if all(ok(v) for v in vals):
                return
            prog = (vals if endpoint == "progress" else
                    [call_serving(n, "progress", None) for n in peer_names])
            if (prog, vals) != seen:
                seen, deadline = (prog, vals), time.time() + stall_s
            elif time.time() > deadline:
                raise RuntimeError(f"{job.name}: barrier '{what}' timed "
                                   f"out ({stall_s:.0f} s without progress)")
            time.sleep(0.02)

    for fn in (nn_kernel.nn_cuda, stats_kernel.moments_cuda,
               stats_kernel.count_cuda):
        fn.launches = 0
    t_run = time.perf_counter()
    with reads:
        for i in range(lo, hi):
            stamp = i * 0.1
            wait_for_peers(i, max_skew=job.tick_every)
            progress["frame"] = i
            serve_pending()
            _, bc = robot.step(stamp, world.scan(traj[i], seed=i))
            if bc is not None:
                for c in peers.values():
                    c.call("odom", bc)
            if (i - lo + 1) % job.tick_every == 0:
                drain(stamp)
                slam.optimization_tick(now=stamp)
                sp = slam.slam_pose_broadcast(stamp)
                if sp is not None:
                    for c in peers.values():
                        c.call("slam_pose", sp)
        progress["frame"] = 10**9  # window done: release a waiting peer
        # end of the run, three phases, each raising on expiry:
        #   B. barrier: every robot reaches its window's end (serving);
        #   C. one final pull of every peer's delta graph (RequestGraphs,
        #      mrg_slam_component.cpp:1249, the reference's join-late
        #      flow), so the last merge does not hang on a broadcast;
        #   D. serve until every peer's final pull is done, so nobody
        #      closes while a peer's phase-C request is in flight.
        barrier("progress", lambda p: p is not None and p >= 10**9,
                "end-of-window")
        n_pulled = slam.request_graphs(peer_names, now=hi * 0.1,
                                       request_fn=request_fn)
        if n_pulled != len(peer_names):
            raise RuntimeError(f"{job.name}: final pull reached {n_pulled} "
                               f"of {peer_names}")
        final_done["done"] = True
        barrier("final_done", bool, "final-pull")
        drain(hi * 0.1)
        slam.optimization_tick(now=hi * 0.1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t_run
        n_reads = reads.count()

    db = slam.db
    own = sorted(db.own_keyframes(), key=lambda k: k.stamp)
    est = (np.stack([k.estimate(db.graph) for k in own])
           if own else np.zeros((0, 7), np.float32))
    gt = traj[[int(round(k.stamp / 0.1)) for k in own]]
    robot_of = {u: k.robot_name for u, k in db.uuid_keyframe_map.items()}
    loops = [e for e in db.edges if e.type == "loop"]
    frames = hi - lo
    result = {
        "name": job.name,
        "frames": frames,
        "wall_s": wall,
        "keyframes": len(own),
        "remote_keyframes": sum(
            1 for k in db.keyframes + db.new_keyframes
            if k.robot_name != job.name),
        "loops": len(loops),
        "received_bytes": sum(slam.received_graph_bytes),
        "sent_bytes": sum(slam.sent_graph_bytes),
        "ate_m": float(ate_rmse(est[:, :3], np.asarray(gt)[:, :3]))
        if len(own) else None,
        # the port's numbers beside the JAX package's keys
        "device": str(device),
        "frames_per_s": frames / max(wall, 1e-9),
        "inter_robot_loops": sum(
            robot_of.get(e.from_uuid) != robot_of.get(e.to_uuid)
            for e in loops),
        "publish_graph": publish,
        "launches": {"nn": nn_kernel.nn_cuda.launches,
                     "moments": stats_kernel.moments_cuda.launches,
                     "count": stats_kernel.count_cuda.launches},
        "host_reads_per_frame": (None if n_reads is None
                                 else n_reads / frames),
        "peak_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
        "peak_reserved_bytes": (torch.cuda.max_memory_reserved(device)
                                if device.type == "cuda" else None),
    }
    save_tum(os.path.join(job.out_dir, f"{job.name}.tum"),
             np.asarray([k.stamp for k in own]), est)
    with open(os.path.join(job.out_dir, f"{job.name}.result.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    server.close()
    for c in peers.values():
        c.close()


@dataclasses.dataclass
class RobotJob:
    name: str
    all_names: List[str]
    window: Tuple[int, int]
    total_frames: int
    world_seed: int
    tick_every: int
    port: int
    out_dir: str
    handshake_path: str
    device: str
    cpu_threads: int  # torch threads of a worker (its share of the cores)
    cfg: object  # EngineConfig


def _default_cfg(name: str, names, init_pose) -> object:
    """The JAX package's worker configuration (multiprocess.py:310-336):
    8192 raw -> 1024 filtered points, no outlier removal, SMALL_GICP with
    radius covariances, 2 m keyframes, a dense LM, no point removal."""
    from ..config import (EngineConfig, LoopClosureConfig, OptimizerConfig,
                          PrefilterConfig, RegistrationConfig,
                          ScanMatchingOdometryConfig, SlamConfig)

    reg = RegistrationConfig(reg_transformation_epsilon=1e-3,
                             reg_maximum_iterations=32,
                             reg_correspondence_randomness=10)
    return EngineConfig(
        prefilter=PrefilterConfig(downsample_resolution=0.4,
                                  capacity_raw_points=8192,
                                  capacity_filtered_points=1024,
                                  outlier_removal_method="NONE"),
        odometry=ScanMatchingOdometryConfig(keyframe_delta_translation=2.0,
                                            registration=reg),
        slam=SlamConfig(own_name=name, multi_robot_names=tuple(names),
                        keyframe_delta_trans=2.0, capacity_keyframes=128,
                        capacity_edges=512, capacity_keyframe_points=1024,
                        registration=reg, init_pose=init_pose,
                        optimizer=OptimizerConfig(
                            solver_backend="dense",
                            g2o_solver_num_iterations=64),
                        loop=dataclasses.replace(LoopClosureConfig(),
                                                 capacity_candidates=4),
                        robot_remove_points_radius=0.0))


def _worker_env() -> Dict[str, str]:
    """The parent's environment with the repo root on PYTHONPATH."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_multiprocess(n_robots: int = 2, total_frames: int = 80,
                     tick_every: int = 15, world_seed: int = 11,
                     out_dir: Optional[str] = None,
                     timeout_s: float = 600.0,
                     device: DeviceLike = None,
                     cpu_threads: Optional[int] = None) -> Dict[str, dict]:
    """Spawn one robot process per overlapping trajectory window, wait,
    and return the per-robot result dicts (kitti_multirobot_processor.py's
    subprocess topology without ROS). The robots run on the card unless
    `device` says otherwise; with no card and no `device` this raises
    before it spawns anything. A worker that exits non-zero fails the
    run. `out_dir` (default: mrg_slam_mp under the temp directory) gets
    each robot's log, result JSON and TUM trajectory. `cpu_threads` is
    each worker's torch thread count (default: its share of the cores,
    cpu_count // n_robots); a caller that shares the host with other
    work passes fewer."""
    import subprocess

    from ..io.synthetic import circle_trajectory

    dev = resolve_device(device)
    if not 1 <= n_robots <= len(NAMES):
        raise ValueError(f"n_robots must be 1..{len(NAMES)}, got {n_robots}")
    if dev.type == "cuda":
        # build once here, so the workers only load the libraries
        from ..ops import native

        native.build_all()
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "mrg_slam_mp")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        if f.endswith((".addr", ".result.json", ".tum")):
            os.remove(os.path.join(out_dir, f))
    names = list(NAMES[:n_robots])
    span = total_frames * 2 // (n_robots + 1)
    step = (total_frames - span) // max(n_robots - 1, 1)
    windows = [(i * step, min(i * step + span, total_frames))
               for i in range(n_robots)]
    traj = circle_trajectory(total_frames, radius=12.0, laps=1.1)
    env = _worker_env()

    procs = []
    try:
        for name, window in zip(names, windows):
            p0 = traj[window[0]]
            yaw = 2.0 * float(np.arctan2(p0[6], p0[3]))
            job = dataclasses.asdict(RobotJob(
                name=name, all_names=names, window=window,
                total_frames=total_frames, world_seed=world_seed,
                tick_every=tick_every, port=0, out_dir=out_dir,
                handshake_path=os.path.join(out_dir, f"{name}.addr"),
                device=str(dev),
                cpu_threads=(cpu_threads if cpu_threads is not None else
                             max(1, (os.cpu_count() or 1) // n_robots)),
                cfg=None))
            job["cfg"] = _default_cfg(
                name, names, (float(p0[0]), float(p0[1]), float(p0[2]),
                              yaw, 0.0, 0.0))
            with open(os.path.join(out_dir, f"{name}.log"), "w") as logf:
                proc = subprocess.Popen([sys.executable, "-c", BOOTSTRAP],
                                        stdin=subprocess.PIPE, stdout=logf,
                                        stderr=subprocess.STDOUT, env=env)
            procs.append((name, proc))
            proc.stdin.write(pickle.dumps(job))
            proc.stdin.close()
        deadline = time.time() + timeout_s
        for name, proc in procs:
            rc = proc.wait(timeout=max(deadline - time.time(), 1.0))
            if rc != 0:
                with open(os.path.join(out_dir, f"{name}.log")) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"robot {name} exited {rc}:\n{tail}")
    finally:
        for _, proc in procs:   # the PIDs we spawned, never patterns
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results: Dict[str, dict] = {}
    for name in names:
        with open(os.path.join(out_dir, f"{name}.result.json")) as f:
            results[name] = json.load(f)
    return results


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--robots", type=int, default=2)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--tick-every", type=int, default=15)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device the robots run on (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)
    results = run_multiprocess(n_robots=args.robots,
                               total_frames=args.frames,
                               tick_every=args.tick_every,
                               out_dir=args.out, device=args.device)
    for name, r in results.items():
        ate = "-" if r["ate_m"] is None else f"{r['ate_m']:.3f}"
        print(f"{name}: {r['frames']} frames, {r['keyframes']} keyframes "
              f"(+{r['remote_keyframes']} remote), {r['loops']} loops "
              f"({r['inter_robot_loops']} inter-robot), ATE {ate} m, rx "
              f"{r['received_bytes'] / 1e3:.0f} kB / tx "
              f"{r['sent_bytes'] / 1e3:.0f} kB, {r['wall_s']:.1f} s on "
              f"{r['device']}")
    return results


if __name__ == "__main__":
    main()
