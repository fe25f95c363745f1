"""A run's result line, the modules it loads, and its refusals."""

import json
import subprocess
import sys

import pytest
from bench_helpers import ROOT, all_cells

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "apm"}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(root, cell, trace):
    return harness.run_cell(root, cell, 2**31 + 99, 0.3, trace, 0.0, device="cpu",
                            log=lambda *a, **k: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", all_cells())
def test_result_line_keys(tiny_root, cell, trace):
    out = run_tiny(tiny_root, cell, trace)
    want = KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert list(out) == want  # the numbers compared come last
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["compared"] == {"mismatched_counts": {"value": 0, "limit": 0}}
    json.loads(json.dumps(out))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer" if trace else "end_to_end"]}
    assert set(out["metrics"]) <= listed
    if not trace:
        assert {"scan_mb_per_s", "call_ms_p95", "setup_s"} == set(out["metrics"])
    else:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert "kernel_ms" in out["metrics"]
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]


_PROBE = """
import sys
sys.path.insert(0, {root!r})
{body}
top = sorted({{m.split('.')[0] for m in sys.modules}})
print(' '.join(top))
"""


def loaded(body):
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax_and_no_apm(tmp_path):
    """Whole top-level names: apm_torch is allowed, apm is not."""
    body = ("import json, shutil, pathlib\n"
            f"sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})\n"
            "from bench_helpers import all_cells, shrink, with_candidates\n"
            f"root = pathlib.Path({str(tmp_path)!r}) / 'c'\n"
            f"shutil.copytree({str(ROOT / 'benchmark')!r}, root / 'benchmark')\n"
            f"bench = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))\n"
            "(root / 'BENCHMARK.json').write_text(json.dumps(with_candidates(bench)))\n"
            "shrink(root)\n"
            "from benchmark import harness\n"
            "import benchmark.run\n"
            "for cell in all_cells():\n"
            "    harness.run_cell(root, cell, 5, 0.2, True, 0.0, device='cpu', log=lambda *a, **k: None)\n")
    top = loaded(body)
    assert "apm_torch" in top and not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    body = ("import numpy as np\n"
            "from benchmark import reference, corpus, roofline, devtrace\n"
            "t = corpus.dna_lines(5000, 50, 1, 'cpu')\n"
            "reference.count_many([t], [t[:50].tobytes()], 3, 'cpu')\n")
    top = loaded(body)
    assert not top & (FORBIDDEN | {"apm_torch"})


def test_no_card_no_result():
    """Without a card a run exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                        "chrom256.stream_k3", "--seed", str(2**31 + 5), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode != 0 and "correct" not in p.stdout


def test_no_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, a run exits non-zero and prints no result line."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "chrom256.stream_k3",
                        "--seed", "5", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and "correct" not in p.stdout
