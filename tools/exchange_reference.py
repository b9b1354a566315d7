"""The JAX package's acceptance rows 4 and 6 on the CPU, with the counts
the PyTorch port's `chip_smoke.py` holds its exchange phase to.

Runs the JAX package's own `pipeline/baseline_runs.config4_two_robot`
(two robots over 30 %-overlapping windows of 100 frames) and
`config6_reversed_encounter` (120 frames, bestla's window played
backwards) at the rows' width (8192 raw -> 1024 filtered points,
`_base_cfg()` with the rows' exchange cadence), unchanged: their ATEs are
the package's own. Its `replay_multirobot` is wrapped only to keep the
robots, from which each robot's keyframes, loops, inter-robot loops
(loop edges whose ends belong to different robots), merged remote
keyframes and graph bytes sent and received are read.

Prints one JSON line per row, then the dict that `chip_smoke.py` keeps as
`REF_EXCHANGE`.

    python tools/exchange_reference.py

Runs on the CPU; expect a few minutes.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from mrg_slam_tpu.pipeline import baseline_runs as bl  # noqa: E402
from mrg_slam_tpu.pipeline import multirobot_split  # noqa: E402
from mrg_slam_tpu.pipeline import replay  # noqa: E402


class KeepRobots:
    """Installed over `replay_multirobot` in the modules that call it:
    keeps the robots of the last call and passes the call on."""

    MODULES = (replay, multirobot_split)

    def __init__(self):
        self.fn = replay.replay_multirobot
        self.robots = None

    def __enter__(self):
        def keep(robots, *args, **kw):
            self.robots = robots
            return self.fn(robots, *args, **kw)

        for m in self.MODULES:
            m.replay_multirobot = keep
        return self

    def __exit__(self, *exc):
        for m in self.MODULES:
            m.replay_multirobot = self.fn


def counts(robots):
    """Per robot: keyframes, loops, inter-robot loops, merged remote
    keyframes, graph bytes sent and received."""
    out = {k: {} for k in ("keyframes", "loops", "inter_robot_loops",
                           "remote_keyframes", "sent_bytes",
                           "received_bytes")}
    for name, robot in robots.items():
        slam, db = robot.slam, robot.slam.db
        loops = [e for e in db.edges if e.type == "loop"]
        robot_of = {u: k.robot_name for u, k in db.uuid_keyframe_map.items()}
        out["keyframes"][name] = len(db.own_keyframes())
        out["loops"][name] = len(loops)
        out["inter_robot_loops"][name] = sum(
            robot_of[e.from_uuid] != robot_of[e.to_uuid] for e in loops)
        out["remote_keyframes"][name] = sum(
            k.robot_name != name and k.odom_counter >= 0
            for k in db.keyframes + db.new_keyframes)
        out["sent_bytes"][name] = int(sum(slam.sent_graph_bytes))
        out["received_bytes"][name] = int(sum(slam.received_graph_bytes))
    return out


def main():
    ref = {}
    for row in (bl.config4_two_robot, bl.config6_reversed_encounter):
        t0 = time.perf_counter()
        with KeepRobots() as keep:
            r = row()
        m = dict(ate_m=r["ate_rmse"], **counts(keep.robots),
                 wall_s=time.perf_counter() - t0)
        print(json.dumps({"config": r["config"], **m}), flush=True)
        ref[r["config"]] = {k: v for k, v in m.items() if k != "wall_s"}
    print("REF_EXCHANGE =", json.dumps(ref, indent=1))


if __name__ == "__main__":
    main()
