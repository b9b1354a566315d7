"""On the card: every synchronizing CUDA call on each benchmark cell's
path is one of the program's `read.*` spans. Over a block of odometry
and a tick with work of each cell's path (one robot: run_batch and
MrgSlam; four co-hosted robots: run_batch_multi and SharedGraphSlam, at
the harness's small CPU-test size), the count that
`torch.cuda.set_sync_debug_mode("warn")` reports equals the count of
`read.*` spans, and each reported call sits inside one. The harness's
own read of a block's odometry outputs (benchmark/system.py) is not the
program's and is left out.

Needs a CUDA card (marker `cuda`); without one it skips. On a machine
with a card and without JAX (tests/conftest.py imports it):
`python -m pytest tests/test_torch_sync_audit.py -q --noconftest
-o addopts=""`."""

import os

import pytest
import torch

from mrg_slam_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell,traffic_name,robots", [
    ("kitti_hdl64", "revisit", 1), ("fleet4_kitti", "survey", 4)])
def test_every_sync_of_a_block_is_a_read_span(cell, traffic_name, robots):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import run, system, traffic
    from benchmark.tests import small

    cfg = run.load_config(cell)
    mix = traffic.load_mix(traffic_name)
    ov = small.overrides(robots)
    run.merge(cfg, ov["config"])
    run.merge(mix, ov["traffic"])
    dev = torch.device("cuda")
    sys_ = system.System(cfg, dev)
    (episode,) = traffic.make_pool(cfg, mix, dev, 2 ** 31 + 99, episodes=1)
    ep = sys_.start(episode, traffic.windows(mix))
    n_blocks = ep.episode.rows.shape[0]
    for _ in range(n_blocks - 1):  # warm: every shape of the path once
        sys_.block(ep, system.Spans())
    assert any(t is not None for t in ep.ticks)
    ep = sys_.start(episode, traffic.windows(mix))
    profiling.reset()
    profiling.enable(True)
    try:
        with profiling.SyncAudit(dev) as audit:
            for _ in range(n_blocks):
                sys_.block(ep, system.Spans())
        reads = [r for r in profiling.records()
                 if r.name.startswith("read.")]
    finally:
        profiling.enable(False)
        profiling.reset()
    assert any(t is not None for t in ep.ticks)
    harness = os.path.join("benchmark", "system.py")
    program = [s for s in audit.sites if not s[0].endswith(harness)]
    assert len(program) < len(audit.sites)  # the harness's reads seen
    outside = [s for s in program if not (s[2] or "").startswith("read.")]
    assert not outside, outside
    assert len(program) == len(reads)
