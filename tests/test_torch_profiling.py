"""The port's tracer and profiling utilities (``apm_torch.utils.profiling``),
as ``tests/test_oracle.py::test_profiling_utilities`` holds ``apm``'s:
``ScanStats``, ``Meter``, ``Spans`` and ``trace``, the last over a CPU
``Scanner.count`` (``torch.profiler``; on the card it adds the kernels).
The spans and counters of a traced ``count``: their names, values and
nesting, and that tracing off records nothing."""

import json
import os

import numpy as np
import pytest
import torch

import apm_torch
from apm_torch import ApmConfig
from apm_torch.utils.corpus import plant
from apm_torch.utils.oracle import count_matches
from apm_torch.utils.profiling import OFF, Meter, ScanStats, Spans, trace

CPU = dict(device="cpu", block_windows=1024)  # 128-window rows: the routes tests' layout
# the program's span names on the count path
PROGRAM_RANGES = {"call", "plan", "fingerprint", "fold", "copy", "launch", "phase 1",
                  "phase 2", "fetch", "wait", "finalize", "rescan dp", "EOF tail"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n, seed, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    return np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), n)]


def _sparse(seed=3):
    """A k = 1 scan of a 32- and a 50-mer cut from the corpus: the filter
    routes it to on-device verification."""
    c = _corpus(40_000, seed)
    return c, [bytes(c[1000:1032]), bytes(c[9000:9050])]


def _dense(seed=52):
    """The dense k = 3 set of ``test_torch_cache.py``: planted every 150
    bytes, so the candidates pass the density threshold and the filtration
    patterns are rescanned."""
    pats = [_corpus(32, seed - 2).tobytes(), _corpus(50, seed - 1).tobytes()]
    c = _corpus(40_000, seed).copy()
    for i, p in enumerate(pats):
        plant(c, np.frombuffer(p, np.uint8), range(400 + 97 * i, len(c) - 300, 150),
              k=3, seed=seed + 1 + i)
    return c, pats


def test_scan_stats_meter_and_stopwatch():
    s = ScanStats(
        corpus_bytes=1_000_000, patterns=6, unique_patterns=2, k=0,
        strategy="single", backend="cuda", block_windows=32768,
        seconds=0.001,
    )
    assert abs(s.mb_per_s - 1000.0) < 1e-6
    assert "1000000 B" in s.line() and "1000.0 MB/s" in s.line()
    m = Meter()
    assert not m.trace and m.last_spans == {} and m.last_records == []


def test_spans_off_cost_one_test():
    """Off, a span is one shared object and a counter records nothing."""
    assert OFF.host("a") is OFF.host("b") is OFF.device("c")
    OFF.count("windows", 5)
    assert OFF.totals() == {} and OFF.records == []


def test_spans_nest_and_count():
    s = Spans(torch.device("cpu"), True, call=7)
    with s.host("call"):
        with s.host("plan"):
            pass
        with s.device("phase 1"):
            s.count("windows", 3)
        s.count("windows", 2)
    totals = s.totals()
    assert set(totals) == {"call", "plan", "phase 1", "#windows"} and totals["#windows"] == 5
    parents = {r.name: r.parent for r in s.records}
    assert parents == {"call": None, "plan": "call", "phase 1": "call"}
    assert {r.call for r in s.records} == {7}
    assert totals["call"] >= totals["plan"] + totals["phase 1"]


@pytest.mark.parametrize("cache_corpus", [True, False])
def test_cache_and_window_counters(cache_corpus):
    """A repeated corpus reads one hit and no miss; with the cache emptied
    one miss and no hit; ``#windows`` is the device's window bound. Without
    a cache key no lookup is counted."""
    c, pats = _sparse()
    c.setflags(write=False)
    sc = apm_torch.Scanner(pats, 1, ApmConfig(cache_corpus=cache_corpus, **CPU))
    want = sc.count(c).tolist()
    assert want == count_matches(c, pats, 1)
    sc.meter.trace = True
    assert sc.count(c).tolist() == want
    got = sc.meter.last_spans
    lookups = {n: got.get(n, 0) for n in ("#cache hit", "#cache miss")}
    assert lookups == ({"#cache hit": 1, "#cache miss": 0} if cache_corpus
                       else {"#cache hit": 0, "#cache miss": 0})
    assert got["#windows"] == sc.device_window_bound(len(c))
    sc._dev_cache.clear()
    assert sc.count(c).tolist() == want
    got = sc.meter.last_spans
    lookups = {n: got.get(n, 0) for n in ("#cache hit", "#cache miss")}
    assert lookups == ({"#cache hit": 0, "#cache miss": 1} if cache_corpus
                       else {"#cache hit": 0, "#cache miss": 0})


@pytest.mark.parametrize("chunk_bytes", [None, 16 << 10])
def test_rescan_counters_count_the_work_handed_to_the_dp(chunk_bytes):
    """On the density route every owned window goes to the rescan once, for
    each filtration pattern: ``#rescan cells`` = bound x the sum of their
    lengths, in one chunk or several; the hot windows pass 5 % of the
    windows."""
    from apm_torch.models.pipeline import make_plan

    c, pats = _dense()
    cfg = dict(chunk_bytes=chunk_bytes) if chunk_bytes else {}
    sc = apm_torch.Scanner(pats, 3, ApmConfig(**cfg, **CPU))
    sc.meter.trace = True
    assert sc.count(c).tolist() == count_matches(c, pats, 3)
    assert sc.last_filtration["route"] == "rescan"
    got = sc.meter.last_spans
    bound = sc.device_window_bound(len(c))
    plens = make_plan(sc, len(c)).plens_filter
    assert sum(plens) == 82 and got["#windows"] == bound
    assert got["#rescan cells"] == bound * sum(plens)
    assert got["#rescan windows"] == bound * 2 and got["#rescan patterns"] == 2
    assert got["#hot windows"] > 0.05 * got["#windows"]
    assert got["#candidates 0"] >= 1 and got["#candidates 1"] >= 1
    assert "rescan dp" in got and "wait" in got


@pytest.mark.parametrize("chunk_bytes", [None, 16 << 10])
def test_rescan_counters_on_the_split_count_the_dense_patterns(chunk_bytes):
    """On the split route the rescan takes the dense 32-mer alone: its
    counters count one pattern over every owned window, once a call, and
    the sparse 50-mers are verified under ``count_hot_batch``."""
    c = _corpus(40_000, 60).copy()
    pats = [_corpus(32, 61).tobytes(), _corpus(50, 62).tobytes(), _corpus(50, 63).tobytes()]
    for i, (p, every) in enumerate(zip(pats, (150, 6_000, 6_000))):
        plant(c, np.frombuffer(p, np.uint8), range(400 + 97 * i, len(c) - 300, every),
              k=3, seed=64 + i)
    cfg = dict(chunk_bytes=chunk_bytes) if chunk_bytes else {}
    sc = apm_torch.Scanner(pats, 3, ApmConfig(**cfg, **CPU))
    sc.meter.trace = True
    assert sc.count(c).tolist() == count_matches(c, pats, 3)
    assert sc.last_filtration["route"] == "split-rescan"
    assert sc.last_filtration["sparse"] == [1, 2]
    got = sc.meter.last_spans
    bound = sc.device_window_bound(len(c))
    assert got["#rescan patterns"] == 1
    assert got["#rescan windows"] == bound and got["#rescan cells"] == bound * 32
    assert got["#hot windows"] > 0.05 * got["#windows"]
    assert "rescan dp" in got and "count_hot_batch" in got


@pytest.mark.parametrize("chunk_bytes", [None, 16 << 10])
def test_filter_item_rows_count_each_launch_of_kernel_d(monkeypatch, chunk_bytes):
    """Traced, each chunk's phase 1 on kernel D adds the rows of an item of
    its launch (``filter_kernel.item_rows``, sized for an H100 off the
    card): once a call in one chunk, once a chunk in several."""
    from apm_torch.models.pipeline import make_plan
    from apm_torch.ops import filter_kernel

    calls = []
    scan = filter_kernel.scan_filter
    monkeypatch.setattr(filter_kernel, "scan_filter", lambda *a, **kw: calls.append(1) or scan(*a, **kw))
    c, pats = _sparse()  # at k = 3 exact pieces of 8 and 12 bytes: kernel D's phase 1
    cfg = dict(chunk_bytes=chunk_bytes) if chunk_bytes else {}
    sc = apm_torch.Scanner(pats, 3, ApmConfig(**cfg, **CPU))
    sc.meter.trace = True
    assert sc.count(c).tolist() == count_matches(c, pats, 3)
    plan = make_plan(sc, len(c))
    (_, items), = filter_kernel.launch_items(plan.plens_filter, 3, plan.wf, plan.halo)
    assert plan.wf == 128 and items.rows == 64
    assert len(calls) == (1 if chunk_bytes is None else -(-len(c) // chunk_bytes))
    assert sc.meter.last_spans["#filter item rows"] == len(calls) * items.rows
    sc.meter.trace = False
    sc.count(c)
    assert "#filter item rows" not in sc.meter.last_spans


def test_call_span_holds_plan_and_wait():
    """``call`` is the root of every span of the call, and holds at least
    its ``plan`` and ``wait`` time; each call has its own id; the counts are
    those of an untraced call."""
    c, pats = _dense()
    sc = apm_torch.Scanner(pats, 3, ApmConfig(**CPU))
    want = sc.count(c).tolist()
    sc.meter.trace = True
    ids = []
    for _ in range(2):
        assert sc.count(c).tolist() == want
        got, recs = sc.meter.last_spans, sc.meter.last_records
        assert got["call"] >= got["plan"] + got["wait"]
        assert [r.name for r in recs if r.parent is None] == ["call"]
        assert {r.parent for r in recs if r.name in ("plan", "launch", "fetch", "finalize")} \
            == {"call"}
        assert {r.parent for r in recs if r.name == "wait"} == {"fetch", "finalize"}
        assert {r.parent for r in recs if r.name in ("phase 1", "phase 2")} == {"launch"}
        (call,) = {r.call for r in recs}
        ids.append(call)
    assert ids[1] == ids[0] + 1


def test_tracing_off_records_nothing():
    """Off, a call leaves no spans and puts no program range in a profiler
    session around it; a call with tracing off after a traced one clears
    the traced call's export."""
    c, pats = _dense()
    sc = apm_torch.Scanner(pats, 3, ApmConfig(**CPU))
    sc.count(c)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sc.count(c)
    assert sc.meter.last_spans == {}
    assert not {e.name for e in prof.events()} & PROGRAM_RANGES
    sc.meter.trace = True
    sc.count(c)
    assert sc.meter.last_spans
    sc.meter.trace = False
    sc.count(c)
    assert sc.meter.last_spans == {} and sc.meter.last_records == []


def test_short_corpus_leaves_no_stale_spans():
    """A traced call that returns early (a corpus of at most k bytes, or too
    short for the device) keeps no span of the call before it."""
    c, pats = _sparse()
    sc = apm_torch.Scanner(pats, 1, ApmConfig(**CPU))
    sc.meter.trace = True
    sc.count(c)
    assert "fetch" in sc.meter.last_spans
    assert sc.count(c[:1]).tolist() == [0, 0]
    assert set(sc.meter.last_spans) == {"call"}
    sc.count(c)
    assert sc.count(c[:40]).tolist() == count_matches(c[:40], pats, 1)
    assert set(sc.meter.last_spans) == {"call", "plan", "EOF tail"}


@pytest.mark.parametrize("k", [1, 3])
def test_tail_windows_count_the_work_handed_to_the_worker(monkeypatch, k):
    """Traced, ``#tail windows`` is the scan patterns (a duplicate scanned
    once) x the EOF-truncated windows ``[dev_bound, n - k)`` handed to the
    host worker; untraced, for a tail counted in line (under
    ``TAIL_WORKER_CELLS`` band cells, or with no device window), or with no
    truncated window, it is absent and ``EOF tail`` is the whole tail."""
    from apm_torch.models import scanner as scanner_mod

    c, pats = _sparse()
    pats = pats + [pats[0], b"ACGTACGTAC"]
    sc = apm_torch.Scanner(pats, k, ApmConfig(**CPU))
    want = count_matches(c, pats, k)
    assert sc.count(c).tolist() == want
    assert sc.meter.last_spans == {}
    sc.meter.trace = True
    assert sc.count(c).tolist() == want  # 3 x (49 - k) windows: in line
    assert "EOF tail" in sc.meter.last_spans and "#tail windows" not in sc.meter.last_spans
    monkeypatch.setattr(scanner_mod, "TAIL_WORKER_CELLS", 1)
    assert sc.count(c).tolist() == want
    dev_bound = sc.device_window_bound(len(c))
    assert dev_bound == len(c) - 50 + 1
    assert sc.meter.last_spans["#tail windows"] == 3 * (len(c) - k - dev_bound) == 3 * (49 - k)
    assert sc.count(c[:40]).tolist() == count_matches(c[:40], pats, k)
    assert "#tail windows" not in sc.meter.last_spans
    # patterns of at most k + 1 bytes: the device owns every window
    short = [b"ACGT"[: k + 1], b"TTGA"[: k]]
    sc = apm_torch.Scanner(short, k, ApmConfig(**CPU))
    sc.meter.trace = True
    assert sc.device_window_bound(len(c)) == len(c) - k
    assert sc.count(c).tolist() == count_matches(c, short, k)
    assert "EOF tail" in sc.meter.last_spans and "#tail windows" not in sc.meter.last_spans


def test_verbose_prints_the_scan_line(capsys):
    c, pats = _sparse()
    apm_torch.Scanner(pats, 1, ApmConfig(verbose=True, **CPU)).count(c)
    assert "MB/s" in capsys.readouterr().err
    apm_torch.Scanner(pats, 1, ApmConfig(**CPU)).count(c)
    assert "MB/s" not in capsys.readouterr().err


def test_trace_writes_a_chrome_trace_of_a_count(tmp_path):
    c = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(3).integers(0, 4, 40_000)]
    pat = bytes(c[1000:1040])
    sc = apm_torch.Scanner([pat], 1, apm_torch.ApmConfig(**CPU))
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


def test_trace_nests_the_programs_ranges_under_call(tmp_path):
    """Under ``trace``, with ``meter.trace`` off, each call's spans are
    ranges in the Chrome trace, inside their call's ``call`` range and
    carrying its id; the call leaves its totals in ``last_spans`` too."""
    c, pats = _dense()
    sc = apm_torch.Scanner(pats, 3, ApmConfig(**CPU))
    want = sc.count(c).tolist()
    with trace(str(tmp_path)):
        for _ in range(2):
            assert sc.count(c).tolist() == want
            ids = {r.call for r in sc.meter.last_records}
    assert {"call", "plan", "phase 1", "rescan dp", "wait"} <= set(sc.meter.last_spans)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("name") in PROGRAM_RANGES]
    calls = {int(e["args"]["Concrete Inputs"][0]): e for e in events if e["name"] == "call"}
    assert len(calls) == 2 and max(calls) in ids
    inner = [e for e in events if e["name"] != "call"]
    assert {"plan", "launch", "phase 1", "phase 2", "fetch", "wait", "finalize",
            "rescan dp", "EOF tail"} <= {e["name"] for e in inner}
    for e in inner:
        parent = calls[int(e["args"]["Concrete Inputs"][0])]
        assert parent["ts"] <= e["ts"] and e["ts"] + e["dur"] <= parent["ts"] + parent["dur"]
    with trace(str(tmp_path / "off")):
        pass
    sc.count(c)  # after the block: off again
    assert sc.meter.last_spans == {}


def test_trace_propagates_the_blocks_exception(tmp_path):
    with pytest.raises(KeyError):
        with trace(str(tmp_path)):
            raise KeyError("from the traced block")
    assert os.listdir(tmp_path)  # written all the same, as apm's trace
