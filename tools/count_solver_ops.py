"""PyTorch ops a Levenberg-Marquardt iteration dispatches, per solver backend.

    python tools/count_solver_ops.py [--tree DIR] [--nodes 256]

Builds bench's solver-section ring (chip_smoke.solver_graph: the ring
and its n/128 Huber chords) on the CPU and runs `graph.solve.optimize`
with 4 and then 8 LM iterations (no early stop) for the dense, chain and
cg backends, counting every ATen op dispatched. Prints one JSON line per
backend: ops an LM iteration (the difference over the 4 extra
iterations), of which ops whose outputs are all empty (they launch no
kernel on a card), and the CG iterations of the 8-iteration run. The
count does not depend on the device, so the CPU gives the card's.

--tree counts the mrg_slam_tpu_torch of another checkout (an unpacked
`git archive` of an earlier commit), to compare two versions.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--nodes", type=int, default=256)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import chip_smoke
    from mrg_slam_tpu_torch.config import OptimizerConfig
    from mrg_slam_tpu_torch.graph import solve

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.empty = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else [out]
            self.ops += 1
            self.empty += all(not isinstance(o, torch.Tensor)
                              or o.numel() == 0 for o in outs)
            return out

    dev = torch.device("cpu")
    for backend in ("dense", "chain", "cg"):
        g = chip_smoke.solver_graph(args.nodes, backend, dev).snapshot()
        aux = solve.chain_aux_for(g) if backend == "chain" else None
        runs = []
        for iters in (4, 8):
            cfg = OptimizerConfig(solver_backend=backend,
                                  g2o_solver_num_iterations=iters,
                                  chi2_rel_tol=0.0)
            with Count() as c:
                res = solve.optimize(g, cfg, aux=aux)
            runs.append((c.ops, c.empty, res.iterations,
                         int(res.cg_iterations)))
        (o4, e4, i4, _), (o8, e8, i8, cg8) = runs
        print(json.dumps({"tree": os.path.abspath(args.tree),
                          "backend": backend, "nodes": args.nodes,
                          "ops_per_lm_iteration": (o8 - o4) / (i8 - i4),
                          "empty_ops_per_lm_iteration": (e8 - e4) / (i8 - i4),
                          "cg_iterations_8": cg8}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
