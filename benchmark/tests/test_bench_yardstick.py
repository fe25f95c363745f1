"""The frozen yardstick: the Myers count against the program's today, and
the reduction of a trace."""

import pytest
import torch

from benchmark import devtrace, roofline


@pytest.mark.parametrize("k", [1, 3, 12])
def test_frozen_myers_count_equals_the_programs(k):
    from apm_torch.utils import roofline as program

    for plens in ([32, 50, 50, 50, 50, 50], [32, 50], [50], [120, 120]):
        for owned in (1, 268435444, 268435456 - k):
            assert roofline.myers_instr(owned, plens, k) == program.myers_instr(owned, plens, k)
    assert roofline.PEAK_HBM == program.PEAK_HBM
    assert roofline.PEAK_INT_ISSUE == program.PEAK_INT_ISSUE


def test_stream_k12_bound():
    """5706 instructions a window: 12 x 18 + 20 x 21 for the 32-mer, and
    12 x 18 + 38 x 21 for each of five 50-mers; 45.8 ms at 256 MiB."""
    instr = roofline.myers_instr(1, [32, 50, 50, 50, 50, 50], 12)
    assert instr == 5706
    least = roofline.least_seconds(instr * (268435456 - 12), 268435456)
    assert abs(least - 0.04579) < 1e-4


def test_roofline_share_counts_each_distinct_pattern():
    """Five distinct 50-mers count five times; a repeated pattern once."""
    from types import SimpleNamespace

    from bench_helpers import ROOT

    from benchmark import spec

    read = spec.reader(ROOT, "myers_roofline")
    n = 268435456
    pats = [b"A" * 32] + [bytes([65 + i]) * 50 for i in range(5)]
    call = SimpleNamespace(patterns=pats + [pats[1]], nbytes=n)
    run = SimpleNamespace(calls=[call], k=12, metric=lambda name: 100.0)
    least = roofline.least_seconds(5706 * (n - 12), n)
    assert abs(read(run) - 100.0 * least / 0.1) < 1e-9


def test_intervals():
    busy = devtrace.union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert busy == [(0, 3), (5, 9)]
    idle = devtrace.gaps(busy, -1, 12)
    assert idle == [(-1, 0), (3, 5), (9, 12)]
    assert devtrace.overlap(idle, [(2, 4), (8, 10)]) == 2


def test_reduce_a_host_trace():
    """On the CPU the trace holds no device activity: busy 0, every idle
    microsecond labelled."""
    prof = devtrace.profiler()
    prof.start()
    with torch.profiler.record_function("window"):
        with torch.profiler.record_function("scanner init"):
            torch.ones(1000).sum()
        with torch.profiler.record_function("count"):
            with torch.profiler.record_function("fold"):
                torch.ones(1000).cumsum(0)
    prof.stop()
    r = devtrace.reduce(prof, ["count"])
    assert r["busy_s"] == 0 and r["window_s"] > 0 and r["device_ops"] == []
    labels = dict(r["idle_gaps"])
    assert {"scanner init", "fold", "harness"} <= set(labels)
    assert abs(sum(labels.values()) - r["window_s"]) < 1e-6
