"""The port's profiling utilities (``apm_torch.utils.profiling``), as
``tests/test_oracle.py::test_profiling_utilities`` holds ``apm``'s:
``ScanStats``, ``Meter``, ``Stopwatch`` and ``trace``, the last over a
CPU ``Scanner.count`` (``torch.profiler``; on the card it adds the
kernels)."""

import json
import os

import numpy as np
import pytest
import torch

import apm_torch
from apm_torch.utils.profiling import Meter, ScanStats, Stopwatch, trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scan_stats_meter_and_stopwatch():
    s = ScanStats(
        corpus_bytes=1_000_000, patterns=6, unique_patterns=2, k=0,
        strategy="single", backend="cuda", block_windows=32768,
        seconds=0.001,
    )
    assert abs(s.mb_per_s - 1000.0) < 1e-6
    assert abs(s.gb_per_s - 1.0) < 1e-9
    assert "1000000 B" in s.line()
    m = Meter()
    m.record(s)
    m.record(s)
    assert m.total_bytes == 2_000_000
    assert abs(m.aggregate_mb_per_s - 1000.0) < 1e-6
    sw = Stopwatch()
    assert sw.lap("phase1") >= 0.0
    sw.lap("phase2")
    assert [name for name, _ in sw.laps] == ["phase1", "phase2"]


def test_trace_writes_a_chrome_trace_of_a_count(tmp_path):
    c = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(3).integers(0, 4, 40_000)]
    pat = bytes(c[1000:1040])
    sc = apm_torch.Scanner([pat], 1, apm_torch.ApmConfig(device="cpu"))
    want = sc.count(c).tolist()
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as d:
        assert d == log_dir
        got = sc.count(c).tolist()
    assert got == want and got[0] >= 1
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    ops = {e.get("name") for e in events if isinstance(e, dict) and e.get("cat") == "cpu_op"}
    assert ops  # the count's operators are in the trace


def test_trace_propagates_the_blocks_exception(tmp_path):
    with pytest.raises(KeyError):
        with trace(str(tmp_path)):
            raise KeyError("from the traced block")
    assert os.listdir(tmp_path)  # written all the same, as apm's trace
