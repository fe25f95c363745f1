"""The capture-panel cell ``capture120.panel64_k12``: its files as specified,
its reference's control, the readers of kernel D's and the overflow
verify's work (``filter_roofline``, ``verify_roofline``) on synthetic runs,
and the cell itself at a CPU test's size and, on the card, at its own."""

import json
import shutil

import pytest
from bench_helpers import ROOT

from benchmark import harness, roofline, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "capture120.panel64_k12"
N = 268435456
SIX = [32, 50, 50, 50, 50, 50]


def _run(spans, k=12, nbytes=N):
    cell = spec.Cell(entry={}, config={}, traffic={"k": k}, end_to_end=[], per_layer=[])
    run = harness.Run(root=str(ROOT), cell=cell, seed=1, traced=True)
    run.calls = [harness.Call(i, 0, 0.2, nbytes, None, s, [], None) for i, s in enumerate(spans)]
    return run


def _read(name, run):
    return spec.reader(ROOT, name)(run)


def test_the_cell_and_its_metrics_as_specified():
    config = {c["name"]: c for c in BENCH["configs"]}["capture120"]
    assert config["file"] == "benchmark/configs/capture120.json"
    assert config["reduced"] == ["corpus"] and len(config["source"]) <= 200
    cell = {w["name"]: w for w in BENCH["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("capture120", "panel64_k12", 1)
    assert BENCH["workloads"][-1] == cell
    c = json.loads((ROOT / config["file"]).read_text())
    assert c["corpus"] == {"bytes": N, "line_bases": N - 1}
    assert c["reference"] == "benchmark/reference_long.py"
    assert c["published"]["probe_bases"] == 120
    t = json.loads((ROOT / "benchmark/traffic/panel64_k12.json").read_text())
    assert t == {"call": "count", "k": 12,
                 "patterns": {"cut": [{"length": 120, "count": 64}], "substitutions_max": 12,
                              "fresh": False},
                 "warmup_calls": 2, "check_calls": 1}
    layers = {m["name"]: (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
                          m["workloads"]) for m in BENCH["per_layer"]}
    assert [m["name"] for m in BENCH["per_layer"]][-2:] == ["filter_roofline", "verify_roofline"]
    assert layers["filter_roofline"] == ("%", "higher", "program_span", "kernels",
                                         "scan_mb_per_s", [CELL, "chrom256.repeat_k3"])
    assert layers["verify_roofline"] == ("%", "higher", "program_span", "kernels",
                                         "scan_mb_per_s", [CELL])
    found = spec.find_cell(ROOT, CELL)
    assert [m["name"] for m in found.per_layer] == ["filter_roofline", "verify_roofline"]
    assert [m["name"] for m in found.end_to_end] == ["scan_mb_per_s", "call_ms_p95", "setup_s"]


def test_a_probe_is_cut_from_the_one_line():
    """One line of 268,435,455 bases: a 120-base cut lies anywhere in it."""
    from benchmark import corpus as gen

    text = gen.dna_lines(20_000, 19_999, 3, "cpu")
    assert (text == 10).sum() == 1 and text[-1] == 10
    rng = gen.stream(3, 1, 0)
    pats = gen.cut_patterns(text, 19_999, [{"length": 120, "count": 64}], 12, rng)
    assert len(pats) == 64 and {len(p) for p in pats} == {120}
    assert all(b"\n" not in p for p in pats)


@pytest.mark.parametrize("plens,k", [([120] * 64, 12), ([120, 120], 8), (SIX, 3), (SIX, 12)])
def test_the_frozen_compare_equals_the_programs_floor(plens, k):
    """``COMPARE_INSTR`` x the pieces per window is the program's
    ``filter_shiftor_model`` at the cells' lengths and k (and at k = 8)."""
    from apm_torch.ops.filter_kernel import filter_eligible, tier_of
    from apm_torch.utils import roofline as program

    read = spec.module(ROOT, "benchmark/metrics/filter_roofline.py")
    plens = [m for m in plens if filter_eligible(m, k)]
    pieces = sum(tier_of(m, k)[0] for m in plens)
    model = program.filter_shiftor_model(plens, k)
    assert read.COMPARE_INSTR * pieces == model.int_instr
    assert read.COMPARE_INSTR == program.COMPARE_OPS


def test_the_panels_bounds():
    """448 pieces of 3 instructions over 256 MiB: 10.8 ms; the overflow
    verify of 1,300 hot rows of 128 windows x 64 probes: 0.79 ms."""
    d_least = roofline.least_seconds(3 * 448 * (N - 12), N)
    assert abs(d_least - 0.01078) < 1e-5
    from benchmark.metrics.rescan_roofline import myers_instr

    w = 1300 * 128 * 64
    assert abs(roofline.least_seconds(myers_instr(w, 120 * w, 12), 0) - 0.00079) < 1e-5


def test_readers_on_the_programs_counters():
    calls = [
        {"phase 1": 100.0, "count_hot_batch": 4.0, "#piece windows": 448 * (N - 12),
         "#banded piece windows": 448 * (N - 12), "#verify windows": 1300 * 128 * 64,
         "#verify cells": 1300 * 128 * 64 * 120},
        {"phase 1": 300.0, "count_hot_batch": 6.0, "#piece windows": 448 * (N - 12),
         "#banded piece windows": 448 * (N - 12), "#verify windows": 1000 * 128 * 64,
         "#verify cells": 1000 * 128 * 64 * 120},
    ]
    run = _run(calls)
    d_least = roofline.least_seconds(3 * 448 * (N - 12), N)
    assert _read("filter_roofline", run) == pytest.approx(100.0 * 2 * d_least / 0.4)
    from benchmark.metrics.rescan_roofline import myers_instr

    v_least = sum(roofline.least_seconds(myers_instr(r * 8192, r * 8192 * 120, 12), 0)
                  for r in (1300, 1000))
    assert _read("verify_roofline", run) == pytest.approx(100.0 * v_least / 0.010)
    # repeat_k3's exact tier: 24 pieces, the call's bytes
    k3 = _run([{"phase 1": 4.0, "#piece windows": 24 * (N - 3)}], k=3)
    want = roofline.least_seconds(3 * 24 * (N - 3), N)
    assert _read("filter_roofline", k3) == pytest.approx(100.0 * want / 0.004)
    assert _read("verify_roofline", k3) is None


@pytest.mark.parametrize("spans", [
    None,  # an untraced run
    {"phase 1": 4.0, "count_hot_batch": 1.0, "rescan dp": 10.0},  # a program without counters
    {"call": 1.0, "#windows": 0},  # a call that ran no filter
])
def test_readers_find_nothing_to_read(spans):
    run = _run([spans, spans])
    for name in ("filter_roofline", "verify_roofline"):
        assert _read(name, run) is None


@pytest.fixture
def capture_root(tmp_path):
    """The benchmark with the capture cell cut to a CPU test's size: 20,000
    bytes in one line and 16 probes of 120 bases, the cell's k and
    substitutions kept."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = root / "benchmark/configs/capture120.json"
    c = json.loads(cfg.read_text())
    c["corpus"] = {"bytes": 20_000, "line_bases": 19_999}
    cfg.write_text(json.dumps(c))
    traffic = root / "benchmark/traffic/panel64_k12.json"
    t = json.loads(traffic.read_text())
    t["patterns"]["cut"][0]["count"] = 16
    traffic.write_text(json.dumps(t))
    return root


@pytest.mark.parametrize("overflow", [False, True])
def test_the_cell_at_a_cpu_tests_size(capture_root, overflow, monkeypatch):
    """Traced, the run reads both new metrics where the counters are there:
    the filter's always, the verify's on the overflow route, which a
    hot-row bucket of 8 forces at this size (re-verified 16 rows a batch)."""
    from apm_torch.ops import fused

    if overflow:
        monkeypatch.setattr(fused, "pick_max_hot", lambda *a: 8)
        monkeypatch.setattr(fused, "OVERFLOW_BATCH", 16)
    out = harness.run_cell(capture_root, CELL, 2**31 + 99, 0.3, True, 0.0, device="cpu",
                           log=lambda *a, **k: None)
    assert out["correct"] is True and out["failed"] == 0
    assert out["compared"] == {"mismatched_counts": {"value": 0, "limit": 0}}
    assert out["metrics"]["filter_roofline"]["value"] > 0
    assert ("verify_roofline" in out["metrics"]) is overflow


def _control(monkeypatch, device):
    """``reference_long`` without its EOF-truncated windows in the
    program's place."""
    from apm_torch import Scanner

    from benchmark import reference_long

    def count(self, corpus):
        return reference_long.count_many([corpus], self.patterns.raw, self.k, device,
                                         eof=False)[0]

    monkeypatch.setattr(Scanner, "count", count)


def test_the_control_fails_at_a_cpu_tests_size(capture_root, monkeypatch):
    _control(monkeypatch, "cpu")
    out = harness.run_cell(capture_root, CELL, 2**31 + 5, 0.0, False, 0.0, device="cpu",
                           log=lambda *a, **k: None)
    assert out["correct"] is False and out["compared"]["mismatched_counts"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 2025, 2**31 + 2026, 2**31 + 2027])
def test_the_control_fails_on_the_card(card, seed, monkeypatch):
    """At the cell's own size, on three seeds: each reading is printed as
    one JSON line."""
    _control(monkeypatch, card)
    out = harness.run_cell(ROOT, CELL, seed, 0.0, False, 0.0, log=lambda *a, **k: None)
    compared = out["compared"]["mismatched_counts"]
    print(json.dumps({"control": CELL, "seed": seed, "mismatched_counts": compared["value"],
                      "limit": compared["limit"]}))
    assert out["correct"] is False and compared["value"] > compared["limit"]
