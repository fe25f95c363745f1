"""The whole-genome cell ``genome3g.repeat_k3``: its files as specified, the
chunks its staging cuts the genome into, the readers of the chunk loop's
and the kernels' time per chunk (``launch_ms_per_chunk``,
``kernel_ms_per_chunk``) on synthetic runs, and the cell itself over
several chunks at a CPU test's size and, on the card, at its own."""

import json
import shutil
from functools import partial

import pytest
from bench_helpers import ROOT, control_in_the_programs_place

from benchmark import harness, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "genome3g.repeat_k3"
N = 3161728832  # GRCh38's 3,099,734,149 bp in 50-base lines, each with its newline
NEW = ("launch_ms_per_chunk", "kernel_ms_per_chunk")


def _run(spans):
    cell = spec.Cell(entry={}, config={}, traffic={"k": 3}, end_to_end=[], per_layer=[])
    run = harness.Run(root=str(ROOT), cell=cell, seed=1, traced=True)
    run.calls = [harness.Call(i, 0, 0.2, N, None, s, [], None) for i, s in enumerate(spans)]
    return run


def _read(name, run):
    return spec.reader(ROOT, name)(run)


def test_the_cell_and_its_metrics_as_specified():
    config = {c["name"]: c for c in BENCH["configs"]}["genome3g"]
    assert BENCH["configs"][-1] == config
    assert config["file"] == "benchmark/configs/genome3g.json"
    assert config["reduced"] == [] and len(config["source"]) <= 200
    cell = {w["name"]: w for w in BENCH["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("genome3g", "repeat_k3", 1)
    assert BENCH["workloads"][-1] == cell
    c = json.loads((ROOT / config["file"]).read_text())
    assert c["corpus"] == {"bytes": N, "line_bases": 50}
    assert c["reference"] == "benchmark/reference.py"
    bp = c["published"]["grch38_genome_bp"]
    assert bp == 3099734149 and N == bp // 50 * 51 + bp % 50 + 1
    layers = {m["name"]: (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
                          m["workloads"]) for m in BENCH["per_layer"]}
    assert tuple(m["name"] for m in BENCH["per_layer"][-2:]) == NEW
    assert layers["launch_ms_per_chunk"] == ("ms", "lower", "program_span", "chunk loop",
                                             "call_ms_p95", [CELL])
    assert layers["kernel_ms_per_chunk"] == ("ms", "lower", "program_span", "kernels",
                                             "scan_mb_per_s", [CELL])
    found = spec.find_cell(ROOT, CELL)
    assert [m["name"] for m in found.per_layer] == list(NEW)
    assert [m["name"] for m in found.end_to_end] == ["scan_mb_per_s", "call_ms_p95", "setup_s"]
    assert found.traffic == spec.find_cell(ROOT, "chrom256.repeat_k3").traffic


def test_the_genome_is_twelve_chunks_the_last_past_2_31():
    """At ``repeat_k3``'s staging (rows of 4096 windows, halo 128) the genome
    is 12 chunks of 65,536 rows, 3.32 GB staged; the last starts at window
    2,952,790,016 and its clipped row past 2^31 too."""
    from apm_torch import ApmConfig, Scanner
    from apm_torch.models.pipeline import chunking, make_plan

    pats = [b"A" * 32] + [bytes([65 + i]) * 50 for i in range(5)]
    sc = Scanner(pats, 3, ApmConfig(device="cpu"))
    plan = make_plan(sc, N)
    assert (plan.wf, plan.halo, plan.dev_bound) == (4096, 128, N - 49)
    chunk_win, n_rows = chunking(plan.w, plan.wf, plan.dev_bound, sc.config.chunk_bytes)
    starts = list(range(0, plan.dev_bound, chunk_win))
    assert (len(starts), n_rows, starts[-1]) == (12, 65536, 2952790016)
    assert 12 * n_rows * (plan.wf + plan.halo) == 3321888768
    assert plan.dev_bound - plan.dev_bound % plan.wf > 2**31


def test_readers_on_the_programs_spans():
    calls = [
        {"launch": 60.0, "phase 1": 12.0, "phase 2": 6.0, "rescan dp": 84.0,
         "count_hot_batch": 6.0, "#chunks": 12},
        {"launch": 36.0, "phase 1": 18.0, "phase 2": 6.0, "rescan dp": 90.0,
         "count_hot_batch": 6.0, "#chunks": 12},
    ]
    run = _run(calls)
    assert _read("launch_ms_per_chunk", run) == pytest.approx(96.0 / 24)
    assert _read("kernel_ms", run) == pytest.approx(114.0)
    assert _read("kernel_ms_per_chunk", run) == pytest.approx(228.0 / 24)
    # one chunk a call: kernel_ms itself
    one = _run([{"launch": 5.0, "phase 1": 3.0, "rescan dp": 7.0, "#chunks": 1}] * 3)
    assert _read("kernel_ms_per_chunk", one) == pytest.approx(_read("kernel_ms", one)) == 10.0
    assert _read("launch_ms_per_chunk", one) == 5.0


@pytest.mark.parametrize("spans", [
    None,  # an untraced run
    {"launch": 60.0, "phase 1": 12.0, "rescan dp": 84.0, "#windows": 10},  # no #chunks
    {"call": 1.0, "plan": 0.2, "EOF tail": 0.5},  # a call that launched no chunk
])
def test_readers_find_nothing_to_read(spans):
    run = _run([spans, spans])
    for name in NEW:
        assert _read(name, run) is None


@pytest.fixture
def genome_root(tmp_path, monkeypatch):
    """The benchmark with the genome cut to a CPU test's size: 256 KiB of
    the same lines, and the program's chunks cut to 32 KiB, so that the
    cell's staging (rows of 4096 windows) gives 8 chunks, the last one
    partial."""
    import apm_torch

    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = root / "benchmark/configs/genome3g.json"
    c = json.loads(cfg.read_text())
    c["corpus"]["bytes"] = 256 << 10
    cfg.write_text(json.dumps(c))
    monkeypatch.setattr(apm_torch, "ApmConfig", partial(apm_torch.ApmConfig, chunk_bytes=32 << 10))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_at_a_cpu_tests_size(genome_root, trace):
    out = harness.run_cell(genome_root, CELL, 2**31 + 99, 0.3, trace, 0.0, device="cpu",
                           log=lambda *a, **k: None)
    assert out["correct"] is True and out["failed"] == 0
    assert out["compared"] == {"mismatched_counts": {"value": 0, "limit": 0}}
    if trace:
        assert set(out["metrics"]) == set(NEW)
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:
        assert set(out["metrics"]) == {"scan_mb_per_s", "call_ms_p95", "setup_s"}


def test_a_traced_call_counts_its_chunks(genome_root):
    """The harness's traced call: 8 chunks in ``#chunks``, one ``launch``
    each."""
    from benchmark.workload import Workload

    cell = spec.find_cell(genome_root, CELL)
    work = Workload(cell.config, cell.traffic, 2**31 + 7, "cpu")
    caller = harness.Caller(work, "cpu", True)
    _, _, spans = caller(work.request(0))
    assert spans["#chunks"] == 8 and spans["launch"] > 0


def test_the_control_fails_at_a_cpu_tests_size(genome_root, monkeypatch):
    control_in_the_programs_place(monkeypatch, "cpu")
    out = harness.run_cell(genome_root, CELL, 2**31 + 5, 0.0, False, 0.0, device="cpu",
                           log=lambda *a, **k: None)
    assert out["correct"] is False and out["compared"]["mismatched_counts"]["value"] > 0


@pytest.mark.cuda
def test_the_cell_is_correct_on_the_card(card):
    out = harness.run_cell(ROOT, CELL, 2**31 + 2024, 2.0, False, 0.0, log=lambda *a, **k: None)
    print(json.dumps({"cell": CELL, "attempted": out["attempted"],
                      "memory_peak_bytes": out["device"]["memory_peak_bytes"]}))
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] >= 3_300_000_000  # the genome is resident


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 2025, 2**31 + 2026, 2**31 + 2027])
def test_the_control_fails_on_the_card(card, seed, monkeypatch):
    """At the cell's own size, on three seeds: each reading is printed as
    one JSON line."""
    control_in_the_programs_place(monkeypatch, card)
    out = harness.run_cell(ROOT, CELL, seed, 0.0, False, 0.0, log=lambda *a, **k: None)
    compared = out["compared"]["mismatched_counts"]
    print(json.dumps({"control": CELL, "seed": seed, "mismatched_counts": compared["value"],
                      "limit": compared["limit"]}))
    assert out["correct"] is False and compared["value"] > compared["limit"]
