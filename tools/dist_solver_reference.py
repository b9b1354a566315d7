"""The JAX package's distributed pose-graph solve on the CPU, with the
graphs and numbers that `tests/test_torch_dist_solver.py` holds the
PyTorch port's `parallel/dist_solver.py` to.

Builds the graphs of the JAX package's tests/test_distributed.py:14-110
(the 24-node noisy ring from `np.random.default_rng(0)`, and the same
ring with every edge family: XYZ and quaternion priors, a fixed floor
plane with SE3-plane edges, a free plane with normal and distance priors
and a plane-identity edge), solves each case with the JAX package's
single-device `solve.optimize` and with its `optimize_distributed` on
meshes of 2 and 4 of 8 virtual CPU devices, and writes

    {"graphs": {name: snapshot arrays}, "cases": {case: {...}}}

where each case holds its graph's name, the OptimizerConfig fields it
changes, the single-device chi2, poses and planes, and per mesh size the
distributed chi2, poses and planes. Arrays are stored exactly, as base64
of their bytes with dtype and shape; an edge table as its capacity and
its live rows (the rest are the empty table's defaults).

    python tools/dist_solver_reference.py \
        [--json tests/data/dist_solver_reference.json]

Takes a few minutes on the CPU, most of it JAX compiling.
"""

import argparse
import base64
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from mrg_slam_tpu.config import OptimizerConfig  # noqa: E402
from mrg_slam_tpu.graph import solve  # noqa: E402
from mrg_slam_tpu.graph.builder import GraphSLAM  # noqa: E402
from mrg_slam_tpu.parallel import dist_solver  # noqa: E402
from mrg_slam_tpu.utils import se3  # noqa: E402

WORLDS = (2, 4)
# case -> (graph, the OptimizerConfig fields it sets)
CASES = {
    "ring_cg": ("ring", dict(solver_backend="cg",
                             g2o_solver_num_iterations=48)),
    "families_dense": ("families", dict(solver_backend="dense",
                                        g2o_solver_num_iterations=48)),
    "families_cg": ("families", dict(solver_backend="cg",
                                     g2o_solver_num_iterations=48)),
    "families_chain": ("families", dict(solver_backend="chain",
                                        g2o_solver_num_iterations=48)),
}


def ring_graph(rng, n=24, drift=0.04):
    """tests/test_distributed.py's `build_ring_graph`."""
    gs = GraphSLAM(OptimizerConfig(solver_backend="cg"),
                   capacity_nodes=64, capacity_edges=64)
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    gt, est, ids = [], [], []
    for i in range(n):
        th = 2 * np.pi * i / n
        gt.append(np.asarray(se3.pose_exp(jnp.asarray(
            [8 * np.cos(th), 8 * np.sin(th), 0, 0, 0, th],
            dtype=jnp.float32))))
    est.append(gt[0])
    ids.append(gs.add_se3_node(gt[0], fixed=True))
    for i in range(1, n):
        rel = np.asarray(se3.pose_between(jnp.asarray(gt[i - 1]),
                                          jnp.asarray(gt[i])))
        noise = np.asarray(se3.pose_exp(jnp.asarray(
            rng.normal(scale=drift, size=6).astype(np.float32))))
        rel_n = np.asarray(se3.pose_compose(jnp.asarray(rel),
                                            jnp.asarray(noise)))
        est.append(np.asarray(se3.pose_compose(jnp.asarray(est[-1]),
                                               jnp.asarray(rel_n))))
        ids.append(gs.add_se3_node(est[-1]))
        gs.add_se3_edge(ids[i - 1], ids[i], rel_n, info)
    rel_loop = np.asarray(se3.pose_between(jnp.asarray(gt[-1]),
                                           jnp.asarray(gt[0])))
    gs.add_se3_edge(ids[-1], ids[0], rel_loop, info * 10)
    return gs, np.stack(gt)


def families_graph():
    """tests/test_distributed.py's `test_distributed_mixed_edge_types`
    graph: the ring with every edge family."""
    gs, gt = ring_graph(np.random.default_rng(0), n=24)
    info3 = np.eye(3, dtype=np.float32)
    for i in range(0, 24, 6):
        gs.add_se3_prior_xyz_edge(i, gt[i][:3], info3 * 25.0)
        gs.add_se3_prior_quat_edge(i, gt[i][3:7], info3 * 4.0)
    plane = gs.add_plane_node([0, 0, 1, 0], fixed=True)
    for i in range(0, 24, 4):
        gs.add_se3_plane_edge(i, plane, [0, 0, 1, 0], info3 * 10.0)
    plane2 = gs.add_plane_node([0.1, 0.0, 0.99, 0.2])
    gs.add_plane_prior_normal_edge(plane2, [0, 0, 1], info3 * 5.0)
    gs.add_plane_prior_distance_edge(plane2, 0.0, 5.0)
    gs.add_plane_identity_edge(plane, plane2, [0, 0, 0, 0],
                               np.eye(4, dtype=np.float32) * 2.0)
    return gs


def encode(a) -> dict:
    a = np.ascontiguousarray(np.asarray(a))
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode()}


def encode_graph(g) -> dict:
    """The graph's node arrays whole; of each edge table its capacity and
    its live rows (the builder fills rows 0..n-1; the rest hold the empty
    table's defaults, so `decode_graph` rebuilds the table exactly)."""
    out = {}
    for f in g._fields:
        v = getattr(g, f)
        if hasattr(v, "_fields"):
            mask = np.asarray(v.mask)
            n = int(mask.sum())
            assert mask[:n].all() and not mask[n:].any(), f
            out[f] = {"capacity": int(mask.shape[0]),
                      "rows": {k: encode(np.asarray(getattr(v, k))[:n])
                               for k in v._fields}}
        else:
            out[f] = encode(v)
    return out


def decode(d) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]), d["dtype"]).reshape(
        d["shape"])


def decode_graph(d: dict, empty) -> dict:
    """{field: array} of an encoded graph, its edge tables padded with
    `empty(capacity)`'s rows (a table type's `empty`)."""
    out = {}
    for f, v in d.items():
        if "rows" not in v:
            out[f] = decode(v)
            continue
        full = {k: np.array(a) for k, a in
                empty[f](v["capacity"])._asdict().items()}
        for k, enc in v["rows"].items():
            rows = decode(enc)
            full[k][: len(rows)] = rows
        out[f] = full
    return out


def result(res, n, n_planes) -> dict:
    return {"chi2_initial": float(res.chi2_initial),
            "chi2_final": float(res.chi2_final),
            "iterations": int(res.iterations),
            "poses": encode(np.asarray(res.poses)[:n]),
            "planes": encode(np.asarray(res.planes)[:n_planes])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", default=os.path.join(
        ROOT, "tests", "data", "dist_solver_reference.json"))
    args = ap.parse_args(argv)
    builders = {"ring": ring_graph(np.random.default_rng(0))[0],
                "families": families_graph()}
    graphs = {k: gs.snapshot() for k, gs in builders.items()}
    # the encoding rebuilds every array of the graph exactly
    from mrg_slam_tpu.graph import types as T
    empty = dict(se3=T.SE3Edges.empty, priors=T.PriorEdges.empty,
                 plane_edges=T.PlaneEdges.empty,
                 plane_priors=T.PlanePriorEdges.empty,
                 plane_plane=T.PlanePlaneEdges.empty)
    for g in graphs.values():
        back = decode_graph(encode_graph(g), empty)
        for f in g._fields:
            v = getattr(g, f)
            if hasattr(v, "_fields"):
                for k in v._fields:
                    assert np.array_equal(np.asarray(getattr(v, k)),
                                          back[f][k]), (f, k)
            else:
                assert np.array_equal(np.asarray(v), back[f]), f
    out = {"graphs": {k: encode_graph(g) for k, g in graphs.items()},
           "nodes": {k: gs.num_nodes for k, gs in builders.items()},
           "planes": {k: int(gs._n_planes) for k, gs in builders.items()},
           "cases": {}}
    for case, (gname, fields) in CASES.items():
        t0 = time.perf_counter()
        g, gs = graphs[gname], builders[gname]
        n, n_pl = gs.num_nodes, int(gs._n_planes)
        cfg = OptimizerConfig(**fields)
        entry = {"graph": gname, "config": fields,
                 "single": result(solve.optimize(g, cfg), n, n_pl)}
        for w in WORLDS:
            mesh = dist_solver.make_mesh(w)
            entry[f"world{w}"] = result(
                dist_solver.optimize_distributed(g, cfg, mesh), n, n_pl)
        out["cases"][case] = entry
        print(json.dumps({"case": case, "single": entry["single"][
            "chi2_final"], **{f"world{w}": entry[f"world{w}"]["chi2_final"]
                              for w in WORLDS},
            "s": round(time.perf_counter() - t0, 1)}), flush=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
