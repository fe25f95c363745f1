"""BENCHMARK.json, and every cell's files found by name."""

import json
import re

import pytest
from bench_helpers import ROOT, all_cells, with_candidates

from benchmark import harness, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and NAME.match(c["name"])
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(names)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves and set(m["workloads"]) <= set(names)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in names:  # every cell reports setup_s, another end-to-end metric and a layer's
        cell = spec.find_cell(ROOT, w)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_issue_metrics_and_layers():
    """The issue's metrics and layers: the committed ones, and with the
    candidate cells the host layers' too."""
    e2e = {m["name"]: (m["unit"], m["better"]) for m in BENCH["end_to_end"]}
    assert e2e == {"scan_mb_per_s": ("MB/s", "higher"), "call_ms_p95": ("ms", "lower"),
                   "setup_s": ("s", "lower")}
    bench = with_candidates(BENCH)
    layers = {m["name"]: (m["unit"], m["layer"], m["moves"]) for m in bench["per_layer"]}
    assert {m["name"] for m in BENCH["per_layer"]} == {
        "kernel_ms", "myers_roofline", "device_idle_pct", "device_mem_gib"}
    assert layers == {
        "scanner_init_ms": ("ms", "entry", "call_ms_p95"),
        "fingerprint_ms": ("ms", "device corpus cache", "scan_mb_per_s"),
        "fold_ms": ("ms", "host staging", "scan_mb_per_s"),
        "copy_ms": ("ms", "host staging", "scan_mb_per_s"),
        "kernel_ms": ("ms", "kernels", "scan_mb_per_s"),
        "myers_roofline": ("%", "kernels", "scan_mb_per_s"),
        "device_idle_pct": ("%", "device", "scan_mb_per_s"),
        "device_mem_gib": ("GiB", "device", "scan_mb_per_s"),
    }


@pytest.mark.parametrize("cell", all_cells())
def test_cell_files_found_by_name(tiny_root, cell):
    c = spec.find_cell(tiny_root, cell)
    assert c.config["name"] == c.entry["config"]
    assert (tiny_root / c.config["reference"]).is_file()
    assert len(c.end_to_end) == 3 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(tiny_root, m["name"]))
    assert c.traffic["call"] in ("count", "count_batch")


def test_traffic_parameters_as_issued():
    def traffic(name):
        return json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())

    reference_shape = [{"length": 32, "count": 1}, {"length": 50, "count": 5}]
    for name, k, fresh in (("stream_k3", 3, True), ("repeat_k3", 3, False),
                           ("stream_k12", 12, True), ("repeat_k12", 12, False)):
        t = traffic(name)
        assert (t["call"], t["k"]) == ("count", k) and "scanner" not in t
        assert t["patterns"]["cut"] == reference_shape and t["patterns"]["fresh"] is fresh
        assert t["patterns"]["substitutions_max"] == k
    t = traffic("batch_k1")
    assert (t["call"], t["k"], t["patterns"]) == ("count_batch", 1, "panel")
    chrom = json.loads((ROOT / "benchmark/configs/chrom256.json").read_text())
    assert chrom["corpus"] == {"bytes": 268435456, "line_bases": 50}
    dna = json.loads((ROOT / "benchmark/configs/inf560dna.json").read_text())
    # the reference's dna/ corpora: its four checked-in files' own sizes, and chr6_4M.fa
    assert dna["contigs"]["sizes"] == [1327, 132803, 183549, 1591301, 4000000]
    assert dna["panel"][0] == {"fill": "Q", "length": 32, "file": "line_non_existent.fa"}
    assert [p["line"] for p in dna["panel"][1:]] == [5, 10, 20, 1131, 20783]
    # line_20783 occurs 4 times in small_chrY_x100.fa's 132,803 bytes
    assert dna["corpus"]["plant"]["every_bytes"] == 132803 // 4 // 100 * 100


def test_a_cell_from_new_files_alone(tiny_root):
    """A new traffic mix, a new metric and a new cell: files and entries
    added, no file of the harness edited."""
    (tiny_root / "benchmark/traffic/stream_k2.json").write_text(json.dumps({
        "call": "count", "k": 2, "warmup_calls": 1, "check_calls": 2,
        "patterns": {"cut": [{"length": 20, "count": 2}], "substitutions_max": 2,
                     "fresh": True}}))
    (tiny_root / "benchmark/metrics/calls_per_s.py").write_text(
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "chrom256.stream_k2", "config": "chrom256",
                               "traffic": "stream_k2", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "entry",
                               "moves": "scan_mb_per_s", "workloads": ["chrom256.stream_k2"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run_cell(tiny_root, "chrom256.stream_k2", 3, 0.3, True, 0.0,
                           device="cpu", log=lambda *a, **k: None)
    assert out["correct"] and out["attempted"] >= 1
    assert out["metrics"]["calls_per_s"]["value"] > 0
