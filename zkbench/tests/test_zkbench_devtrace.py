"""The device trace's arithmetic on made-up intervals: the idle share is
one less the union of device intervals over the window, so work that
overlaps on two streams counts once; gaps go to the innermost host
range that holds their start."""

import pytest

from zkbench.harness import devtrace
from zkbench.harness.readings import Readings, roofline


def _trace(events):
    return devtrace.DeviceTrace.from_events(events)


EVENTS = [
    ("zkbench:window", "range", 0, 1000),
    ("job:prove_chain", "range", 0, 900),
    ("phase:wave_lde", "range", 100, 400),
    ("phase:wave_assembly", "range", 300, 600),
    ("k1", "device", 100, 300),
    ("k2", "device", 200, 400),       # overlaps k1 on a second stream
    ("k1", "device", 500, 550),
    ("cudaLaunchKernel", "launch", 90, 91),
    ("cudaLaunchKernel", "launch", 190, 191),
    ("cuLaunchKernel", "launch", 490, 491),
    ("cudaMemcpyAsync", "launch", 495, 496),
    ("aten::add", "other", 10, 20),
    ("k0", "device", -50, -10),       # before the window
]


def test_union_counts_overlap_once():
    t = _trace(EVENTS)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx(350e-9)          # [100,400) + [500,550)
    summed = sum(e - s for _, s, e in t.ops) * 1e-9   # 200 + 200 + 50
    assert summed == pytest.approx(450e-9)
    ctx = Readings(spec=None, cfg={}, trace=t)
    assert _idle(ctx) == pytest.approx(65.0)          # 1 - 350 / 1000
    assert 100 * (1 - summed / 1000e-9) == pytest.approx(55.0)


def _idle(ctx):
    from zkbench.harness.spec import Spec
    return Spec().metric("device.idle_share").read(ctx)


def test_launches_and_kernel_time_by_name():
    t = _trace(EVENTS)
    assert t.launches == 3
    assert t.kernel_seconds("k1") == (pytest.approx(250e-9), 2)
    assert [name for name, _ in t.top_ops()] == ["k1", "k2"]


def test_gaps_go_to_the_innermost_range():
    t = _trace(EVENTS)
    got = dict(t.top_gaps())
    # [0,100): job; [400,500): assembly (open, started after the job);
    # [550,600): assembly; [600,900): job; [900,1000): no range
    assert got["job:prove_chain"] == pytest.approx(400e-9)
    assert got["phase:wave_assembly"] == pytest.approx(150e-9)
    assert "phase:wave_lde" not in got
    assert got["host:(outside any phase)"] == pytest.approx(100e-9)
    assert sum(got.values()) == pytest.approx(1000e-9 - t.busy_s)


def test_union_and_gaps_helpers():
    assert devtrace.union_length([(0, 10), (5, 20), (30, 40)]) == 30
    assert devtrace.gaps([(0, 10), (5, 20)], 0, 30) == [(20, 30)]
    assert devtrace.gaps([], 0, 5) == [(0, 5)]


def test_a_trace_needs_one_window():
    with pytest.raises(ValueError):
        _trace([("k", "device", 0, 1)])


def test_roofline_needs_the_log_and_the_trace_to_agree():
    t = _trace(EVENTS)
    ctx = Readings(spec=None, cfg={}, trace=t, logs={"k1": [10, 20]})
    assert roofline(ctx, "k1", "k1", lambda log: 125e-9) == \
        pytest.approx(50.0)
    ctx.logs["k1"] = [10]            # one launch logged, two in the trace
    assert roofline(ctx, "k1", "k1", lambda log: 125e-9) is None
    ctx.logs["k1"] = []
    assert roofline(ctx, "k1", "k1", lambda log: 1.0) is None
