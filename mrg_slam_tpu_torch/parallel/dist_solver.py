"""Distributed pose-graph optimization over torch.distributed ranks.

Counterpart of the JAX package's parallel/dist_solver.py, which runs the
LM under `shard_map` over a device mesh. Here the mesh is a process group:
each rank is a process, and the LM loop of graph/solve.py runs SPMD on
every rank with the node state replicated.

- dense and cg: the edge tables are split into contiguous blocks, one a
  rank (`shard_edges`, after `pad_edges_to` the group size with masked
  lanes, which add nothing to chi2 or H); every reduction over edges
  (chi2, the gradient, the diagonal blocks, the dense Hessian, H v inside
  PCG) is one sum over the group (solve._sum_over: recursive doubling
  for a gloo group of 2^m ranks, else `all_reduce(SUM)`).
- chain, and "auto" past the dense envelope: the graph is whole on every
  rank and the chain factorization's segment panels are split over the
  ranks (graph/chain_solver.py), with a segment length whose segment
  count the group divides (`solve._chain_K`).

Every rank sees the same bits after each reduction, so the accept and
reject decisions, lambda and the early stop agree, and every rank
returns the same poses.

The group's backend is named, never guessed: gloo on the CPU and for
ranks that share one card (CUDA tensors pass through the host), nccl for
one rank a card. nccl with more ranks than cards raises.

Usage (each rank a process; `run_ranks` starts them):

    group = init_group(rank, world_size, "tcp://localhost:29500", device)
    res = optimize_distributed(graph, cfg, group)
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..config import OptimizerConfig
from ..graph import solve
from ..graph.types import EDGE_TABLES, PoseGraphData
from ..runtime import DeviceLike, resolve_device


def pad_edges_to(g: PoseGraphData, multiple: int) -> PoseGraphData:
    """Each edge table's capacity padded to a multiple of `multiple`; the
    new lanes are zero, so their mask is False."""
    def pad_table(t):
        cap = t.mask.shape[0]
        extra = -cap % multiple
        if not extra:
            return t
        return type(t)(*(torch.cat([f, f.new_zeros((extra,) + f.shape[1:])])
                         for f in t))

    return g._replace(**{name: pad_table(getattr(g, name))
                         for name in EDGE_TABLES})


def shard_edges(g: PoseGraphData, rank: int, world_size: int
                ) -> PoseGraphData:
    """Rank `rank`'s shard: the rank-th contiguous block of every edge
    table (padded to the group size first), the node and plane arrays
    whole (the twin of the JAX package's `shard_graph_inputs`)."""
    g = pad_edges_to(g, world_size)

    def block(t):
        c = t.mask.shape[0] // world_size
        return type(t)(*(f[rank * c: (rank + 1) * c] for f in t))

    return g._replace(**{name: block(getattr(g, name))
                         for name in EDGE_TABLES})


def optimize_distributed(g: PoseGraphData, cfg: OptimizerConfig, group,
                         aux=None) -> solve.OptimizeResult:
    """The LM of graph.solve.optimize over the ranks of `group`, called on
    every rank with the whole graph `g` on the rank's device. dense and
    cg run on this rank's edge shard; chain (and "auto" past the dense
    envelope) on the whole graph with the factorization's panels split.
    Returns the same result on every rank."""
    backend = solve.resolve_backend(cfg.solver_backend, g.n_nodes,
                                    g.n_planes, cfg.auto_dense_max_dofs)
    if backend == "chain":
        return solve.optimize(g, cfg, aux=aux, group=group)
    local = shard_edges(g, group.rank(), group.size())
    return solve.optimize(local, cfg, group=group)


# ---------------------------------------------------------------------------
# process groups and the ranks' processes
# ---------------------------------------------------------------------------

def group_backend(device: torch.device, world_size: int,
                  backend: Optional[str] = None) -> str:
    """The backend a group of `world_size` ranks on `device` uses: gloo on
    the CPU and when the ranks share the cards, nccl when asked and every
    rank has its own card. nccl with more ranks than cards raises: two
    ranks cannot share a card under nccl, and nothing falls back."""
    if backend is None:
        if device.type == "cpu" or world_size > torch.cuda.device_count():
            return "gloo"
        return "nccl"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("nccl runs on CUDA cards; use gloo on the CPU")
        n_cards = torch.cuda.device_count()
        if world_size > n_cards:
            raise ValueError(
                f"nccl needs one card a rank: {world_size} ranks on "
                f"{n_cards} card(s); use backend='gloo' for ranks that "
                "share a card")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def rank_device(device: torch.device, rank: int) -> torch.device:
    """A rank's device: its card (ranks round-robin over the cards), or
    the CPU."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_group(rank: int, world_size: int, init_method: str,
               device: DeviceLike = None, backend: Optional[str] = None):
    """Join the default process group with an explicit backend
    (`group_backend`) and return it."""
    import torch.distributed as dist

    dev = resolve_device(device)
    name = group_backend(dev, world_size, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev, rank))
    dist.init_process_group(name, init_method=init_method, rank=rank,
                            world_size=world_size)
    return dist.group.WORLD


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world_size: int, init_method: str, device: str,
               backend: Optional[str], fn: Callable, args: tuple,
               out_dir: str) -> None:
    """One rank's process: join the group, run fn(group, device, *args),
    write its result (or its traceback) under out_dir. A rank takes one
    torch thread: the ranks share the host's cores."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        group = init_group(rank, world_size, init_method, device, backend)
        try:
            out = fn(group, rank_device(torch.device(device), rank), *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world_size: int, device: DeviceLike = None,
              args: tuple = (), backend: Optional[str] = None,
              timeout_s: float = 600.0) -> List:
    """Run fn(group, device, *args) on `world_size` ranks, each a spawned
    process joined in one group on `device` (the card unless said
    otherwise), and return the ranks' results in rank order. `fn` and
    `args` are pickled (fn by its import path). A rank that fails fails
    the run: the others are stopped and RuntimeError carries its
    traceback."""
    import multiprocessing as mp

    dev = resolve_device(device)
    group_backend(dev, world_size, backend)  # refuse before spawning
    if dev.type == "cuda":
        from ..ops import native

        native.build_all()  # the ranks load the libraries built here
    ctx = mp.get_context("spawn")
    init_method = f"tcp://localhost:{free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank_main, args=(
            r, world_size, init_method, str(dev), backend, fn, args,
            out_dir), daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.time() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    raise RuntimeError(_rank_failure(out_dir, bad[0],
                                                     procs[bad[0]]))
                if time.time() > deadline:
                    raise RuntimeError(f"ranks still running after "
                                       f"{timeout_s:.0f} s")
                time.sleep(0.02)
            for r, p in enumerate(procs):
                if p.exitcode != 0:
                    raise RuntimeError(_rank_failure(out_dir, r, p))
            out = []
            for r in range(world_size):
                with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in procs:   # the processes we spawned, never patterns
                if p.is_alive():
                    p.kill()
                p.join()


def _rank_failure(out_dir: str, rank: int, proc) -> str:
    path = os.path.join(out_dir, f"rank{rank}.err")
    tail = ""
    if os.path.exists(path):
        with open(path) as f:
            tail = f.read()[-4000:]
    return f"rank {rank} exited {proc.exitcode}:\n{tail}"


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

def graph_to(g: PoseGraphData, device: torch.device) -> PoseGraphData:
    """The graph's tensors on `device`."""
    def move(f):
        if isinstance(f, tuple):  # an edge table
            return type(f)(*(x.to(device) for x in f))
        return f.to(device)

    return PoseGraphData(*(move(f) for f in g))


def solve_graphs(group, device: torch.device,
                 cases: Sequence[tuple]) -> List[dict]:
    """`optimize_distributed` of each (graph, cfg) case on this rank, the
    graph moved to the rank's device -> per case: poses, planes, chi2
    initial and final, LM iterations, wall seconds (ending in a sync),
    the reductions over the group the solve made and their host wall."""
    out = []
    for g, cfg in cases:
        g = graph_to(g, device)
        calls0, secs0 = solve._sum_over.calls, solve._sum_over.seconds
        t0 = time.perf_counter()
        res = optimize_distributed(g, cfg, group)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        out.append(dict(
            poses=res.poses.cpu().numpy(), planes=res.planes.cpu().numpy(),
            chi2_initial=float(res.chi2_initial),
            chi2_final=float(res.chi2_final), iterations=res.iterations,
            cg_iterations=int(res.cg_iterations), wall_s=wall,
            all_reduces=solve._sum_over.calls - calls0,
            all_reduce_s=solve._sum_over.seconds - secs0,
            peak_allocated_bytes=(torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)))
    return out


def ranks_equal(results: Sequence[List[dict]]) -> bool:
    """Whether every rank returned bitwise the same poses and planes in
    every case."""
    first = results[0]
    return all(np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32))
               for other in results[1:] for a, b in zip(first, other)
               for k in ("poses", "planes"))
