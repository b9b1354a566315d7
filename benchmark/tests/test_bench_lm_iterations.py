"""The LM-iterations reader by hand (that a tick's `iterations` are its
`lm.iteration` spans is tests/test_torch_tracing.py's)."""

import types

import pytest

from benchmark.run import reader


def test_lm_iterations_reader_by_hand():
    ticks = [types.SimpleNamespace(iterations=3),
             types.SimpleNamespace(iterations=8)]
    rec = types.SimpleNamespace(ticks=ticks)
    assert reader("lm_iterations_per_tick").read(rec) == pytest.approx(5.5)
    rec.ticks = []
    assert reader("lm_iterations_per_tick").read(rec) is None
