"""The harness's whole run on the CPU at a small size, without the look
for a card: a sound run is correct, and each fault the cells can have,
planted under the timed path, makes `correct` come out false."""

import json

import pytest
import torch

from benchmark import run
from benchmark.tests import small

SEED = 2 ** 31 + 12345


def _run(capsys, cell, robots, fault=None, trace=0):
    """One run, its window long enough to finish an episode on the CPU
    (the judge draws a finished one); traced, one more episode after it
    under the profiler."""
    ov = small.overrides(robots)
    ov["config"]["limits"] = small.LIMITS
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "6", "--trace", str(trace)], device="cpu",
                  overrides=ov, fault=fault)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _state_unchanged(monkeypatch):
    """Every Gauss-Newton solve returns the pose it was started from."""
    from mrg_slam_tpu_torch.ops import registration as reg

    def stuck(params, source, target, init_pose, max_iters):
        r = reg.RegistrationResult
        one = torch.ones((), dtype=torch.int32)
        return r(pose=init_pose.to(torch.float32), converged=one > 0,
                 iterations=one, error=one.float(), num_inliers=one,
                 hessian=torch.eye(6))

    def stuck_rows(params, source, target, init_pose, max_iters):
        n = init_pose.shape[0]
        one = torch.ones(n, dtype=torch.int32)
        return reg.RegistrationResult(
            pose=init_pose.to(torch.float32), converged=one > 0,
            iterations=one, error=one.float(), num_inliers=one,
            hessian=torch.eye(6).expand(n, 6, 6))

    def plant(_system):
        monkeypatch.setattr(reg, "_align_impl", stuck)
        monkeypatch.setattr(reg, "align_rows", stuck_rows)
    return plant


def _half_batch(monkeypatch):
    """The prefilter filters the first half of a block and hands it out
    twice, the rest of the block left out."""
    from mrg_slam_tpu_torch.ops import prefilter as pf
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    real = pf.prefilter

    def half(cloud, cfg, *a, **k):
        n = cloud.points.shape[0] // 2
        c = real(PointCloud(cloud.points[:n], cloud.mask[:n]), cfg, *a, **k)
        return PointCloud(torch.cat([c.points, c.points]),
                          torch.cat([c.mask, c.mask]))

    def plant(_system):
        monkeypatch.setattr(pf, "prefilter", half)
    return plant


def _answer_altered(monkeypatch):
    """The odometry's pose of each block's first frame comes out 0.5 m
    off in x."""
    from mrg_slam_tpu_torch.models import odometry_fused as fused
    real_one, real_multi = fused.run_batch, fused.run_batch_multi

    def alter(outs):
        pose = outs.pose.clone()
        pose[..., 0, 0] += 0.5
        return outs._replace(pose=pose)

    def one(*a, **k):
        carry, outs = real_one(*a, **k)
        return carry, alter(outs)

    def multi(*a, **k):
        carry, outs = real_multi(*a, **k)
        return carry, alter(outs)

    def plant(_system):
        monkeypatch.setattr(fused, "run_batch", one)
        monkeypatch.setattr(fused, "run_batch_multi", multi)
    return plant


def _no_loops(monkeypatch):
    """The loop detector selects no candidate: no tick closes a loop."""
    from mrg_slam_tpu_torch.models import loop_detector as ld

    def plant(_system):
        monkeypatch.setattr(ld.LoopDetector, "_select",
                            lambda self, jobs, results, k: [])
    return plant


CELLS = [("kitti_hdl64.revisit", 1), ("fleet4_kitti.survey", 4)]


def _named(cell, trace):
    """The cell's metrics of a run of this kind that a CPU run reports
    (those of the device trace need a card)."""
    return {m["name"] for m in run.cell_metrics(run.load_spec(), cell, trace)
            if m["source"] != "device_trace"}


@pytest.mark.parametrize("cell,robots", CELLS)
def test_sound_run_is_correct(capsys, cell, robots):
    res = _run(capsys, cell, robots, trace=1)
    assert res["correct"], res["checks"]
    assert _named(cell, True) <= set(res["metrics"])
    res = _run(capsys, cell, robots, trace=0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert _named(cell, False) == set(res["metrics"])
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell,robots", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered, _no_loops])
def test_fault_is_caught(capsys, monkeypatch, cell, robots, fault):
    res = _run(capsys, cell, robots, fault(monkeypatch))
    assert not res["correct"], res["checks"]
