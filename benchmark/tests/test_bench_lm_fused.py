"""The fused-LM share reader by hand, and its silence on a program
without the counter."""

import types

import pytest

from benchmark.run import reader


def test_lm_fused_share_reader_by_hand():
    tick = types.SimpleNamespace
    rec = types.SimpleNamespace(ticks=[
        tick(iterations=3, lm_fused_iterations=3),
        tick(iterations=8, lm_fused_iterations=0)])
    for name in ("lm_fused_share", "lm_fused_share.card"):
        assert reader(name).read(rec) == pytest.approx(100.0 * 3 / 11)
    rec.ticks = [tick(iterations=3)]  # a program without the counter
    assert reader("lm_fused_share").read(rec) is None
    rec.ticks = []
    assert reader("lm_fused_share").read(rec) is None
