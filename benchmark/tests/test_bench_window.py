"""The window's arithmetic: all stacks over all its seconds."""

import pytest

from benchmark.core.window import PoolExhausted, Window


def test_rate_is_all_stacks_over_all_time():
    w = Window(10.0)
    w.open(100.0)
    times = [101.0, 103.0, 104.0, 107.5, 110.5]
    closed = [w.complete(t) for t in times]
    assert closed == [False, False, False, False, True]
    assert w.length == pytest.approx(10.5)
    assert w.rate == pytest.approx(5 / 10.5)


def test_a_stall_inside_the_window_lowers_the_rate():
    steady, stalled = Window(10.0), Window(10.0)
    steady.open(0.0)
    stalled.open(0.0)
    for k in range(1, 11):
        steady.complete(1.0 * k)
    t = 0.0
    for k in range(1, 100):
        t += 4.0 if k == 3 else 1.0  # one stack stalls 3 s
        if stalled.complete(t):
            break
    assert stalled.rate < steady.rate
    assert stalled.rate == pytest.approx(len(stalled.done) / stalled.length)


def test_the_pool_runs_out_loudly():
    with pytest.raises(PoolExhausted, match="pool_stacks"):
        raise PoolExhausted(64)
