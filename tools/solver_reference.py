"""Large-graph solver results of the JAX package on bench's solver graphs.

Runs the graphs of bench.py's `run_solvers` (bench.py:478-564) through the
JAX package on the CPU: `build_ring_graph(n, capacity n, 2n edges, seed
0)` plus n/128 Huber chords across the ring, solved with 64 LM
iterations by the dense backend at 1024 nodes and by the chain backend
at 1024 and 8192 nodes; then the exact chain marginals of the unsolved
8192-node graph. It also runs acceptance row 5's single-device half
(`baseline_runs.config5_distributed`): the cg backend on
`build_ring_graph(256)` with 40 iterations. Prints chi2 before and
after and LM iterations of each solve, and the 6x6 marginal blocks of
every 512th node, as one JSON line. The PyTorch port's `chip_smoke.py`
holds its solver phase to these numbers (`REF_SOLVERS` there).

The JAX package's float32 chain marginals come out NaN on that graph: the
reduced separator system of its 8192-node open chain is too ill-
conditioned for a float32 Cholesky. So the marginal blocks printed are
what those chain marginals define, computed exactly: the diagonal blocks
of (H + 1e-6 I)^-1 over the free dofs (the ridge the chain path puts on
T at lam = 0), with H assembled in float64 from the JAX package's
linearization and solved by a sparse LU (scipy), next to whether the
JAX package's own chain marginals are finite.

    python tools/solver_reference.py

Runs on the CPU in a few minutes.
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

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import scipy.sparse.linalg as spl  # noqa: E402

from mrg_slam_tpu.config import OptimizerConfig  # noqa: E402
from mrg_slam_tpu.graph import solve  # noqa: E402
from mrg_slam_tpu.graph.chain_solver import chain_marginals_jit  # noqa: E402
from mrg_slam_tpu.pipeline.baseline_runs import build_ring_graph  # noqa: E402
from mrg_slam_tpu.utils import se3np  # noqa: E402

MARGINAL_STRIDE = 512
CHAIN_RIDGE = 1e-6  # the chain path's damping floor on T at lam = 0


def solver_graph(n, backend):
    """bench.py:486-495: the ring and its n/128 Huber chords."""
    gs = build_ring_graph(n_nodes=n, capacity_nodes=n, capacity_edges=2 * n,
                          backend=backend, seed=0)
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    for i in range(0, n - n // 2, 64):
        j = i + n // 2
        rel = se3np.pose_between(gs.poses[i], gs.poses[j])
        gs.add_se3_edge(i, j, rel, info * 0.25, kernel="Huber",
                        kernel_delta=1.0)
    return gs


def run(g, backend, iters):
    cfg = OptimizerConfig(solver_backend=backend,
                          g2o_solver_num_iterations=iters)
    aux = solve.chain_aux_for(g) if backend == "chain" else None
    t0 = time.perf_counter()
    res = solve.optimize(g, cfg, aux=aux)
    jax.block_until_ready(res.poses)
    return dict(chi2_initial=float(res.chi2_initial),
                chi2_final=float(res.chi2_final),
                iterations=int(res.iterations),
                cpu_s=time.perf_counter() - t0)


def exact_marginals(g, nodes, ridge=CHAIN_RIDGE):
    """Diagonal 6x6 blocks of (H + ridge I)^-1 over the free dofs at
    `nodes`, zero for fixed and invalid nodes: H assembled in float64 from
    the JAX package's SE3 linearization, solved by a sparse LU."""
    lin = solve.linearize(g)
    f, t = np.asarray(g.se3.from_idx), np.asarray(g.se3.to_idx)
    J = {"f": (f, np.asarray(lin.Ji, np.float64)),
         "t": (t, np.asarray(lin.Jj, np.float64))}
    W = np.asarray(lin.W_se3, np.float64)
    n = g.n_nodes
    rows, cols, vals = [], [], []
    for ia, Ja in J.values():
        for ib, Jb in J.values():
            blk = np.einsum("eai,eab,ebj->eij", Ja, W, Jb)
            r = ia[:, None, None] * 6 + np.arange(6)[None, :, None]
            c = ib[:, None, None] * 6 + np.arange(6)[None, None, :]
            rows.append(np.broadcast_to(r, blk.shape).ravel())
            cols.append(np.broadcast_to(c, blk.shape).ravel())
            vals.append(blk.ravel())
    H = sp.csc_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(6 * n, 6 * n))
    free_node = np.asarray(g.node_mask) & ~np.asarray(g.node_fixed)
    free = np.repeat(free_node, 6)
    pos = np.cumsum(free) - 1  # a free dof's row in the reduced system
    lu = spl.splu(sp.csc_matrix(H[free][:, free]
                                + ridge * sp.eye(int(free.sum()))))
    live = [k for k in nodes if free_node[k]]
    E = np.zeros((int(free.sum()), 6 * len(live)))
    for c, k in enumerate(live):
        E[pos[6 * k:6 * k + 6], 6 * c:6 * c + 6] = np.eye(6)
    X = lu.solve(E)
    out = np.zeros((len(nodes), 6, 6))
    for c, k in enumerate(live):
        out[nodes.index(k)] = X[pos[6 * k:6 * k + 6], 6 * c:6 * c + 6]
    return out


def main():
    t0 = time.perf_counter()
    out = {}
    for n, backend in ((1024, "dense"), (1024, "chain"), (8192, "chain")):
        out[f"{backend}_{n}"] = run(solver_graph(n, backend).snapshot(),
                                    backend, 64)
        print(f"# {backend} {n}: {out[f'{backend}_{n}']}", flush=True)
    out["cg_256_row5"] = run(build_ring_graph(256).snapshot(), "cg", 40)
    print(f"# cg 256 (row 5): {out['cg_256_row5']}", flush=True)
    g8 = solver_graph(8192, "chain").snapshot()
    cov = np.asarray(chain_marginals_jit(g8, solve.chain_aux_for(g8),
                                         solve._chain_K(g8.n_nodes)))
    nodes = list(range(0, 8192, MARGINAL_STRIDE))
    out["jax_chain_marginals_8192_finite"] = bool(np.isfinite(cov).all())
    out["marginal_nodes"] = nodes
    out["chain_marginals_8192"] = exact_marginals(g8, nodes).tolist()
    out["cpu_s"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
