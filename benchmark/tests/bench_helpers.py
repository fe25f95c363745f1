"""Helpers of the benchmark's tests."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def shrink(root: Path) -> None:
    """Cut the configurations in ``root`` to sizes a CPU test holds: the
    same shapes, lines, panel kinds and traffic, fewer bytes."""
    cfg = root / "benchmark" / "configs"
    c = json.loads((cfg / "chrom256.json").read_text())
    c["corpus"]["bytes"] = 40_000
    (cfg / "chrom256.json").write_text(json.dumps(c))
    c = json.loads((cfg / "inf560dna.json").read_text())
    c["corpus"]["bytes"] = 120_000
    c["corpus"]["plant"].update(lines=[5, 10, 20, 1131, 2000], every_bytes=8192)
    c["panel"][-1]["line"] = 2000
    c["contigs"]["sizes"] = [60, 1327, 3000, 5000, 12_000]
    (cfg / "inf560dna.json").write_text(json.dumps(c))


def cells():
    with open(ROOT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def control_in_the_programs_place(monkeypatch, device) -> None:
    """The control put in the program's place: ``Scanner.count`` and
    ``count_batch`` answer with the plain reference that leaves out the
    EOF-truncated windows, which breaks the configurations' guarantee."""
    from apm_torch import Scanner

    from benchmark import reference

    def count(self, corpus):
        return reference.count_many([corpus], self.patterns.raw, self.k, device, eof=False)[0]

    def count_batch(self, corpora):
        return reference.count_many(corpora, self.patterns.raw, self.k, device, eof=False)

    monkeypatch.setattr(Scanner, "count", count)
    monkeypatch.setattr(Scanner, "count_batch", count_batch)


# Cells that PERF.md keeps for a later benchmark PR (host-bound: their runs
# spread past what a bound can hold on the card's shared host). Their
# files are here and the CPU tests run them in a copy of BENCHMARK.json
# that lists them; the committed BENCHMARK.json does not.
CANDIDATE_CONFIGS = [
    {"name": "inf560dna", "file": "benchmark/configs/inf560dna.json", "reduced": [],
     "source": "https://github.com/linomp/INF560-approximate-pattern-matching",
     "why": "the reference's own five test corpora in one count_batch call"},
]
CANDIDATE_CELLS = [
    {"name": "chrom256.stream_k3", "config": "chrom256", "traffic": "stream_k3", "chips": 1,
     "why": "a new Scanner and probe set a call at k=3: hash, fold and copy every call"},
    {"name": "inf560dna.batch_k1", "config": "inf560dna", "traffic": "batch_k1", "chips": 1,
     "why": "count_batch of the reference's 5 corpora a call at k=1: fold of each, #4's band"},
    {"name": "chrom256.stream_k12", "config": "chrom256", "traffic": "stream_k12", "chips": 1,
     "why": "a new Scanner and probe set a call at k=12: cold staging, C's Myers mode"},
]
STREAM = ["chrom256.stream_k3", "chrom256.stream_k12"]
STAGED = STREAM + ["inf560dna.batch_k1"]
CANDIDATE_METRICS = [
    {"name": "scanner_init_ms", "unit": "ms", "better": "lower", "source": "host_clock",
     "layer": "entry", "moves": "call_ms_p95", "workloads": STREAM},
    {"name": "fingerprint_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "device corpus cache", "moves": "scan_mb_per_s", "workloads": STREAM},
    {"name": "fold_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "host staging", "moves": "scan_mb_per_s", "workloads": STAGED},
    {"name": "copy_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "host staging", "moves": "scan_mb_per_s", "workloads": STAGED},
]
# the committed metrics that the candidate cells report too
CANDIDATE_IN = {"kernel_ms": STAGED, "device_idle_pct": STAGED, "device_mem_gib": STAGED,
                "myers_roofline": ["chrom256.stream_k12"]}


def with_candidates(bench: dict) -> dict:
    """``bench`` with the candidate cells, their configuration and metrics."""
    bench = json.loads(json.dumps(bench))
    bench["configs"] += CANDIDATE_CONFIGS
    bench["workloads"] += CANDIDATE_CELLS
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + CANDIDATE_IN.get(m["name"], [])
    bench["per_layer"] += CANDIDATE_METRICS
    return bench


def all_cells():
    """The committed cells and the candidates: what the CPU tests run."""
    return cells() + [w["name"] for w in CANDIDATE_CELLS]
