"""The control of `correct` on the card: the plain reference computed in
float32 with TF32 matmuls (the nearest precision below the float32 with
TF32 off that the configurations state), put in the program's place, has
to come out not correct on every seed, at the cell's own size.

Run on the card: `python3 -m pytest -m cuda benchmark/tests`.
"""

import pytest
import torch

from benchmark import run, system, traffic
from benchmark.reference import judge

SEEDS = (2 ** 31 + 100, 3_000_000_001, 979)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only "
                    "the card has")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kitti_hdl64.revisit",
                                  "fleet4_kitti.survey"])
def test_control_is_not_correct(card, cell):
    w = {c["name"]: c for c in run.load_spec()["workloads"]}[cell]
    cfg = run.load_config(w["config"])
    mix = traffic.load_mix(w["traffic"])
    sys_ = system.System(cfg, card)
    wins = traffic.windows(mix)
    for seed in SEEDS:
        pool = traffic.make_pool(cfg, mix, card, seed, episodes=1)
        runs, _, _ = run.window(sys_, pool, wins, 0.0, system.Spans(),
                                episodes=1)
        out = system.outputs(sys_, runs[0], wins)
        nums, _ = judge.judge(cfg, runs[0].episode, out, card, seed,
                              control=True)
        over = [k for k, v in nums.items() if v > cfg["limits"][k]]
        assert over, (seed, nums)
