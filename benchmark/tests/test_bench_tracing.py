"""The readers of the program's own spans and counters (``host_ms``,
``plan_ms``, ``cache_hit_pct``, ``filter_pass_pct``, ``rescan_roofline``),
and the traced window's reduction over a trace that carries the program's
ranges beside the harness's."""

import json
from types import SimpleNamespace

import pytest
import torch
from bench_helpers import ROOT, with_candidates

from benchmark import devtrace, harness, roofline, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("host_ms", "plan_ms", "cache_hit_pct", "filter_pass_pct", "rescan_roofline")
SIX = [32, 50, 50, 50, 50, 50]
N = 268435456


def _run(spans, k=3, nbytes=N):
    cell = spec.Cell(entry={}, config={}, traffic={"k": k}, end_to_end=[], per_layer=[])
    run = harness.Run(root=str(ROOT), cell=cell, seed=1, traced=True)
    run.calls = [harness.Call(i, 0, 0.05, nbytes, None, s, [], None) for i, s in enumerate(spans)]
    return run


def _read(name, run):
    return spec.reader(ROOT, name)(run)


def test_the_tracing_metrics_are_listed():
    """The five per-layer metrics, with their unit, layer, end-to-end metric
    and cells, beside the committed ones (an addition to
    ``test_bench_spec.py``'s exact set)."""
    both = ["chrom256.repeat_k3", "chrom256.repeat_k12"]
    bench = with_candidates(BENCH)
    layers = {m["name"]: (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
                          m["workloads"]) for m in BENCH["per_layer"]}
    assert {n: layers[n] for n in NEW} == {
        "host_ms": ("ms", "lower", "program_span", "entry", "call_ms_p95", both),
        "plan_ms": ("ms", "lower", "program_span", "plan", "call_ms_p95", both),
        "cache_hit_pct": ("%", "higher", "program_counter", "device corpus cache",
                          "scan_mb_per_s", both),
        "filter_pass_pct": ("%", "lower", "program_counter", "kernels", "scan_mb_per_s",
                            both[:1]),
        "rescan_roofline": ("%", "higher", "program_span", "kernels", "scan_mb_per_s",
                            both[:1]),
    }
    assert [m["name"] for m in BENCH["per_layer"]][-5:] == list(NEW)
    assert {m["layer"] for m in bench["per_layer"]} == {
        "entry", "plan", "device corpus cache", "host staging", "kernels", "device"}


def test_readers_on_the_programs_spans():
    calls = [
        {"call": 6.0, "plan": 0.25, "wait": 4.0, "rescan dp": 50.0, "#cache hit": 1,
         "#windows": 1000, "#hot windows": 100, "#rescan windows": 6000,
         "#rescan cells": 282000},
        {"call": 8.0, "plan": 0.75, "wait": 6.0, "rescan dp": 50.0, "#cache hit": 1,
         "#windows": 1000, "#hot windows": 300, "#rescan windows": 6000,
         "#rescan cells": 282000},
    ]
    run = _run(calls, nbytes=1003)
    assert _read("host_ms", run) == pytest.approx(2.0)
    assert _read("plan_ms", run) == pytest.approx(0.5)
    assert _read("cache_hit_pct", run) == 100.0
    assert _read("filter_pass_pct", run) == pytest.approx(20.0)
    least = roofline.least_seconds(roofline.myers_instr(1000, SIX, 3), 1003)
    assert _read("rescan_roofline", run) == pytest.approx(100.0 * least / 0.05)
    calls[1].update({"#cache hit": 0, "#cache miss": 3})
    assert _read("cache_hit_pct", _run(calls)) == 25.0


@pytest.mark.parametrize("spans", [
    None,  # an untraced run
    {"fingerprint": 0.1, "phase 1": 4.0, "rescan dp": 48.0, "fetch": 5.0, "finalize": 49.0,
     "EOF tail": 0.4},  # the names of a program without counters or root spans
    {"call": 1.0, "#windows": 0},  # a call that ran no filter and looked nothing up
])
def test_readers_find_nothing_to_read(spans):
    run = _run([spans, spans])
    if spans and "call" in spans:
        assert _read("host_ms", run) == 1.0
        assert _read("plan_ms", run) is None
    else:
        assert _read("host_ms", run) is None and _read("plan_ms", run) is None
    for name in ("cache_hit_pct", "filter_pass_pct", "rescan_roofline"):
        assert _read(name, run) is None


@pytest.mark.parametrize("k", [1, 3, 12])
def test_rescan_count_equals_the_frozen_myers_count(k):
    """k S W + M (C - k W) over the six-pattern set is ``myers_instr``, the
    pair's halving included, for odd and even window counts."""
    read = spec.module(ROOT, "benchmark/metrics/rescan_roofline.py")
    for owned in (1, 7, 268435444, N - k):
        want = roofline.myers_instr(owned, SIX, k)
        assert read.myers_instr(owned * 6, owned * 282, k) == want
    run = _run([{"rescan dp": 40.0, "#rescan windows": 6 * (N - k),
                 "#rescan cells": 282 * (N - k)}], k=k)
    least = roofline.least_seconds(roofline.myers_instr(N - k, SIX, k), N)
    assert read.read(run) == pytest.approx(100.0 * least / 0.04)


def test_rescan_bound_at_the_cells_k3():
    """3216 instructions a window at k = 3: 25.8 ms at 256 MiB."""
    assert roofline.myers_instr(2, SIX, 3) == 2 * 3216
    least = roofline.least_seconds(roofline.myers_instr(N - 3, SIX, 3), N)
    assert abs(least - 0.0258) < 1e-4


def _ev(name, s, e, cuda=False, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=e),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           is_user_annotation=annotation)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_reduce_labels_the_same_idle_with_the_programs_ranges():
    """A window of two calls as the harness marks it (its ``count`` ranges
    and its copies of the host spans) against the same window where the
    program also emits its ranges: the host spans doubled, ``call``,
    ``plan``, ``launch``, ``wait`` and the device spans, and their
    projections on the device's timeline. The idle time is labelled the
    same, and no program range counts as device work."""
    harness_marks, program = [_ev("window", 0, 1000)], []
    for t in (0, 500):
        harness_marks += [_ev("count", t + 10, t + 400), _ev("fingerprint", t + 30, t + 40),
                          _ev("fetch", t + 100, t + 200), _ev("finalize", t + 210, t + 360),
                          _ev("EOF tail", t + 360, t + 390),
                          _ev("dp_myers_kernel", t + 220, t + 350, cuda=True),
                          _ev("filter_pieces_kernel", t + 60, t + 150, cuda=True)]
        program += [_ev("call", t + 11, t + 399), _ev("plan", t + 12, t + 20),
                    _ev("fingerprint", t + 31, t + 39), _ev("launch", t + 50, t + 90),
                    _ev("phase 1", t + 55, t + 70), _ev("fetch", t + 101, t + 199),
                    _ev("wait", t + 120, t + 198), _ev("finalize", t + 211, t + 359),
                    _ev("rescan dp", t + 212, t + 215), _ev("wait", t + 216, t + 358),
                    _ev("EOF tail", t + 361, t + 389)]
        program += [_ev(n, t + 60, t + 150, cuda=True, annotation=True)
                    for n in ("call", "launch", "phase 1")]
        program += [_ev("rescan dp", t + 220, t + 350, cuda=True, annotation=True)]
    before = devtrace.reduce(_Prof(harness_marks), ["count"])
    after = devtrace.reduce(_Prof(harness_marks + program), ["count"])
    assert after == before
    names = {n for n, _ in after["device_ops"]}
    assert names == {"dp_myers_kernel", "filter_pieces_kernel"}
    assert after["busy_s"] == pytest.approx(2 * 220 / 1e6)


def test_a_traced_cpu_count_under_the_harness_patch():
    """On the CPU, with the harness's patch and the program's own ranges
    both on, each host span is two nested ranges of one name, which the
    profiler's events give as one; the reduction labels every idle
    microsecond once."""
    import numpy as np

    from apm_torch import ApmConfig, Scanner

    rng = np.random.default_rng(5)
    c = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 30_000)]
    c.setflags(write=False)
    sc = Scanner([bytes(c[100:132]), bytes(c[900:950])], 3,
                 ApmConfig(device="cpu", block_windows=1024))
    sc.count(c)
    sc.meter.trace = True
    prof = devtrace.profiler()
    with devtrace.marked_host_spans():
        prof.start()
        with torch.profiler.record_function("window"):
            with torch.profiler.record_function("count"):
                sc.count(c)
        prof.stop()
    names = [e.name for e in prof.events()]
    assert names.count("EOF tail") == 1 and names.count("fetch") == 1
    assert {"call", "plan", "launch", "wait", "phase 1"} <= set(names)
    r = devtrace.reduce(prof, ["count"])
    labels = dict(r["idle_gaps"])
    assert r["busy_s"] == 0 and r["device_ops"] == []
    assert abs(sum(labels.values()) - r["window_s"]) < 1e-6
    assert labels["EOF tail"] * 1e3 <= sc.meter.last_spans["EOF tail"] + 0.05
