"""The port's Scanner end to end on the CPU against apm and the oracle.

``apm_torch.Scanner(..., ApmConfig(device="cpu"))`` (plain PyTorch
versions of the kernels), ``apm.Scanner`` (its Pallas kernels in interpret
mode) and ``apm.utils.oracle.count_matches`` must give the same counts —
integers, tolerance 0. Also: the routing decisions (``corr_impl`` at every
k), and the options the port refuses instead of degrading quietly.
"""

import numpy as np
import pytest
import torch

import apm
from apm import ApmConfig as JaxConfig
from apm.utils.oracle import count_matches

import apm_torch
from apm_torch import ApmConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n, seed, alphabet=b"ACGT\n"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


def _three_way(corpus, pats, k, engine="auto", **cfg):
    want = count_matches(corpus, pats, k)
    jsc = apm.Scanner(
        pats, k,
        JaxConfig(backend="pallas", interpret=True, block_windows=1024,
                  engine=engine, **cfg),
    )
    tsc = apm_torch.Scanner(
        pats, k, ApmConfig(device="cpu", block_windows=1024, engine=engine, **cfg)
    )
    got_j = jsc.count(corpus).tolist()
    got_t = tsc.count(corpus).tolist()
    assert got_t == want, ("port", got_t, want)
    assert got_j == want, ("apm", got_j, want)
    return tsc


@pytest.mark.parametrize("engine", ["auto", "dp"])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_scanner_matches_apm_and_oracle(k, engine):
    from apm_torch.utils.corpus import plant

    c = _corpus(40_000, 100 + k)
    p50, p32 = bytes(c[1000:1050]), bytes(c[20_000:20_032])
    plant(c, np.frombuffer(p50, np.uint8), [5000, 17_000, 33_333], k=k, seed=1)
    # an EOF-truncated match: the pattern's prefix ends the corpus
    c[-20:] = np.frombuffer(p32[:20], np.uint8)
    pats = [p32, p50, p32, b"ACGTACGTAC"]  # duplicate pattern included
    tsc = _three_way(c, pats, k, engine)
    assert tsc.last_strategy == "single" and tsc.last_duration is not None


def test_scanner_corr_route_at_k0():
    # m_max >= 48 at k = 0: apm's plan takes the correlation engine; the
    # port serves it with the fused correlation kernel's plain version.
    from apm_torch.models.pipeline import make_plan

    c = _corpus(30_000, 7, b"ACGT")
    pats = [bytes(c[300:350]), bytes(c[9_000:9_032])]
    tsc = _three_way(c, pats, 0)
    plan = make_plan(tsc, len(c))
    assert plan.use_corr
    assert (plan.routes.corr, plan.routes.fp1) == ("fused", None)


def test_scanner_long_patterns_k0_route_to_conv():
    # 97 < m_max <= 512 at k = 0 under engine='auto': past the fused
    # kernel, apm runs its XLA conv; the port runs the same conv in conv1d
    from apm_torch.models.pipeline import make_plan

    c = _corpus(20_000, 8, b"ACGT")
    pats = [bytes(c[100:220]), bytes(c[5000:5010])]
    tsc = _three_way(c, pats, 0)
    plan = make_plan(tsc, len(c))
    assert plan.use_corr
    assert (plan.routes.corr, plan.routes.fp1) == ("conv", None)


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("corr_impl", ["auto", "conv", "fused"])
def test_scanner_corr_impl_three_way(corr_impl, k):
    # every corr_impl at k = 0 (kernel B or the conv) and k = 1 (conv phase
    # 1: the piece conv, or kernel #7 under "fused"), with planted copies
    from apm_torch.models.pipeline import make_plan
    from apm_torch.utils.corpus import plant

    c = _corpus(40_000, 500 + k)
    p50, p32 = bytes(_corpus(50, 501, b"ACGT")), bytes(_corpus(32, 502, b"ACGT"))
    plant(c, np.frombuffer(p50, np.uint8), [2000, 19_000, 30_001], k=k, seed=503)
    plant(c, np.frombuffer(p32, np.uint8), [9000], k=0)
    tsc = _three_way(c, [p32, p50], k, corr_impl=corr_impl)
    routes = make_plan(tsc, len(c)).routes
    corr, fp1 = routes.corr, routes.fp1
    if k == 0:
        assert (corr, fp1) == ("conv" if corr_impl == "conv" else "fused", None)
    else:
        assert (corr, fp1) == (None, "fused" if corr_impl == "fused" else "conv")


def test_scanner_tiny_corpora():
    pats = [b"ACGTA", b"GG"]
    for n in (0, 1, 2, 3, 6):
        c = _corpus(n, n)
        for k in (0, 2):
            sc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu"))
            assert sc.count(c).tolist() == count_matches(c, pats, k)


def test_scan_counts_and_backends_agree():
    c = _corpus(10_000, 9)
    pats = [bytes(c[10:40]), b"ACGT"]
    want = count_matches(c, pats, 1)
    assert apm_torch.scan_counts(c, pats, 1, ApmConfig(device="cpu")) == want
    sc = apm_torch.Scanner(pats, 1, ApmConfig(device="cpu", backend="torch"))
    assert sc.count(c).tolist() == want
    with pytest.raises(ValueError):
        apm_torch.Scanner(pats, 1, ApmConfig(device="cpu", backend="cuda"))


_P32 = bytes(_corpus(32, 12, b"ACGT"))
_P50 = bytes(_corpus(50, 13, b"ACGT"))


@pytest.mark.parametrize(
    "cfg,k,pats,exc",
    [
        (dict(dp_dtype="int16"), 1, [b"ACGTACGTAC"], NotImplementedError),
        # the sharded strategies run (tests/test_torch_parallel.py); the
        # narrow DP dtypes stay refused under them too
        (dict(dp_dtype="int8", strategy="database_over_devices"), 0, [b"ACGT"],
         NotImplementedError),
        (dict(dp_dtype="int16", strategy="patterns_over_devices"), 0, [b"ACGT"],
         NotImplementedError),
        (dict(dp_dtype="int8", max_devices=2), 0, [b"ACGT"], NotImplementedError),
    ],
)
def test_scanner_refuses_unported_options(cfg, k, pats, exc):
    c = _corpus(5_000, 11, b"ACGT")
    with pytest.raises(exc, match="ROADMAP|int32"):
        apm_torch.Scanner(pats, k, ApmConfig(device="cpu", **cfg)).count(c)


@pytest.mark.parametrize(
    "cfg,k,pats",
    [
        # corr_impl="fused" at k >= 1: conv phase 1 through the fused piece
        # scan (TPU kernel #7), whatever dp_impl verifies with
        (dict(corr_impl="fused"), 1, [_P32, _P50]),
        (dict(corr_impl="fused", dp_impl="myers"), 3, [_P50, _P50[::-1]]),
    ],
)
def test_scanner_fused_phase1_options(cfg, k, pats):
    from apm_torch.utils.corpus import plant

    c = _corpus(20_000, 11, b"ACGT")
    plant(c, np.frombuffer(_P50, np.uint8), [1500, 12_000], k=k, seed=4)
    _three_way(c, pats, k, **cfg)


@pytest.mark.parametrize(
    "cfg,k", [(dict(engine="filter"), 1), (dict(dp_impl="myers"), 3)]
)
def test_scanner_runs_filter_engine_and_myers(cfg, k):
    # both were refused before the shift-OR filter and the bit-parallel
    # band were ported; now three-way equal
    from apm_torch.utils.corpus import plant

    c = _corpus(30_000, 14 + k)
    plant(c, np.frombuffer(_P50, np.uint8), [3000, 21_000], k=k, seed=2)
    pats = [_P32, _P50, b"ACGTACGTAC"]
    want = count_matches(c, pats, k)
    jsc = apm.Scanner(pats, k, JaxConfig(backend="pallas", interpret=True,
                                         block_windows=1024, **cfg))
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=1024, **cfg))
    assert tsc.count(c).tolist() == want
    assert jsc.count(c).tolist() == want
    assert want[1] >= 2


@pytest.mark.parametrize(
    "cfg,exc",
    [
        (dict(corr_impl="conv"), None),
        (dict(engine="corr", corr_impl="fused"), ValueError),
        (dict(engine="corr"), None),
    ],
)
def test_scanner_correlation_routes(cfg, exc):
    # corr_impl="conv" and engine="corr" at m_max 120 run apm's conv
    # (port == apm == oracle); "fused" past m_max 97 is refused by both
    c = _corpus(5_000, 10, b"ACGT")
    long_pat = [bytes(c[100:220])]  # m_max 120: past the fused kernel
    pats = long_pat if "engine" in cfg else [bytes(c[100:150])]
    c[3000 : 3000 + len(pats[0])] = np.frombuffer(pats[0], np.uint8)
    if exc is None:
        tsc = _three_way(c, pats, 0, **cfg)
        assert tsc.count(c).tolist()[0] >= 2
        return
    for pkg, config in ((apm_torch, ApmConfig(device="cpu", **cfg)),
                        (apm, JaxConfig(backend="pallas", interpret=True, **cfg))):
        with pytest.raises(exc, match="fused"):
            pkg.Scanner(pats, 0, config).count(c)


CALL = {"call", "plan", "fingerprint", "fold", "copy", "launch", "fetch", "wait", "EOF tail",
        "#cache hit", "#cache miss", "#windows", "#chunks"}


@pytest.mark.parametrize(
    "k, engine, names",
    [
        (0, "auto", CALL | {"corr"}),
        (2, "dp", CALL | {"dp"}),
        (3, "auto", CALL | {"phase 1", "phase 2", "finalize", "#hot windows",
                            "#candidates 0", "#candidates 1", "#piece windows",
                            "#banded piece windows", "#filter item rows"}),
    ],
)
def test_scanner_spans_name_each_phase(k, engine, names):
    """Meter.trace leaves the scan's phase spans and counters in
    meter.last_spans, and changes no count. A repeated corpus is a device
    cache hit, whose spans hold no fold and no copy; with the cache emptied
    the call stages again."""
    from apm_torch.utils.corpus import plant

    c = _corpus(60_000, 300 + k)
    p32, p50 = _corpus(32, 301, b"ACGT"), _corpus(50, 302, b"ACGT")
    plant(c, p50, range(700, len(c) - 100, 9_000), k=k, seed=303)
    pats = [p32.tobytes(), p50.tobytes()]
    sc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", engine=engine))
    off = sc.count(c).tolist()
    assert sc.meter.last_spans == {}
    sc.meter.trace = True
    assert sc.count(c).tolist() == off == count_matches(c, pats, k)
    assert set(sc.meter.last_spans) == names - {"fold", "copy", "#cache miss"}
    sc._dev_cache.clear()
    assert sc.count(c).tolist() == off
    assert set(sc.meter.last_spans) == names - {"#cache hit"}
    assert all(ms >= 0 for ms in sc.meter.last_spans.values())


def _tail_corpus(n, k, lengths, seed):
    """``n`` bytes and patterns of ``lengths`` whose prefixes end the text:
    pattern ``i`` begins with the text's last ``m_min - 1 - 3 i`` bytes, so
    the EOF-truncated window there matches it exactly (a window of more
    than ``k`` bytes, past every device-owned start)."""
    c = _corpus(n, seed, b"ACGT")
    tail = c[n - min(lengths) + 1 :]
    pats = [tail[3 * i :].tobytes() + _corpus(m - len(tail) + 3 * i, seed + 1 + i, b"ACGT").tobytes()
            for i, m in enumerate(lengths)]
    assert [len(p) for p in pats] == lengths
    return c, pats


@pytest.mark.parametrize(
    "k,lengths,n,cells,worker",
    [(0, [12, 50], 30_000, None, False), (1, [32, 50, 50], 30_000, None, False),
     (3, [32, 50], 30_000, None, False), (3, [32, 50], 30_000, 1, True),
     (12, [120] * 8, 12_000, None, True), (2, [40, 60], 50, 1, False)],
)
def test_count_counts_the_tail_on_the_host_worker(monkeypatch, k, lengths, n, cells, worker):
    """Planted matches in the EOF-truncated windows are counted as the
    oracle counts them: on the host worker where the device owns windows
    and the tail holds ``TAIL_WORKER_CELLS`` band cells or more (eight
    120-byte probes at k = 12: 1.4 M; any tail with the bar lowered to 1);
    on the calling thread for a smaller tail (the chrom256 sets' 50-170 K)
    and where the device owns no window (a text shorter than ``m_max``)."""
    import threading

    from apm_torch.models import scanner as scanner_mod
    from apm_torch.utils import native

    if cells is not None:
        monkeypatch.setattr(scanner_mod, "TAIL_WORKER_CELLS", cells)
    c, pats = _tail_corpus(n, k, lengths, 940 + k)
    sc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=1024))
    real, threads = native.banded_count_set, []

    def spy(*a, **kw):
        threads.append(threading.get_ident())
        return real(*a, **kw)

    monkeypatch.setattr(native, "banded_count_set", spy)
    want = count_matches(c, pats, k)
    assert sc.count(c).tolist() == want
    assert all(w > 0 for w in want)
    assert (sc.device_window_bound(n) > 0) == (n > max(lengths))
    assert len(threads) == 1 and (threads[0] != threading.get_ident()) == worker


def test_a_failing_tail_fails_the_call_and_the_next_call_counts(monkeypatch):
    """A tail that raises on the worker raises from ``count``; a call that
    raises before the join raises its own error, with the tail cancelled
    or finished, never left running; the Scanner's next call counts."""
    import time

    from apm_torch.models.scanner import Scanner
    from apm_torch.utils import native

    from apm_torch.models import scanner as scanner_mod

    c, pats = _tail_corpus(30_000, 1, [32, 50], 960)
    sc = apm_torch.Scanner(pats, 1, ApmConfig(device="cpu", block_windows=1024))
    want = count_matches(c, pats, 1)
    real, state = native.banded_count_set, []
    monkeypatch.setattr(scanner_mod, "TAIL_WORKER_CELLS", 1)  # this small tail too

    def boom(*a, **kw):
        raise OSError("the tail failed")

    def slow(*a, **kw):
        state.append("start")
        time.sleep(0.2)
        out = real(*a, **kw)
        state.append("end")
        return out

    def bad_launch(self, *a, **kw):
        raise RuntimeError("the launch failed")

    monkeypatch.setattr(native, "banded_count_set", boom)
    with pytest.raises(OSError, match="the tail failed"):
        sc.count(c)
    monkeypatch.setattr(Scanner, "_launch_chunk", bad_launch)
    with pytest.raises(RuntimeError, match="the launch failed"):
        sc.count(c)
    monkeypatch.setattr(native, "banded_count_set", slow)
    with pytest.raises(RuntimeError, match="the launch failed"):
        sc.count(c)
    at_raise = list(state)
    time.sleep(0.5)  # a tail left running would start or end meanwhile
    assert state == at_raise and at_raise in ([], ["start", "end"])
    monkeypatch.undo()
    monkeypatch.setattr(scanner_mod, "TAIL_WORKER_CELLS", 1)
    assert sc.count(c).tolist() == want


@pytest.mark.parametrize("chunk_bytes", [256 << 20, 8 << 10])  # one chunk, several
def test_the_tail_is_submitted_before_the_first_launch(monkeypatch, chunk_bytes):
    """The worker starts the tail before the first chunk's launch: the
    launch waits for the tail's start, which the old order (the tail after
    ``finalize``) would never give it."""
    import threading

    from apm_torch.models import scanner as scanner_mod
    from apm_torch.models.scanner import Scanner
    from apm_torch.utils import native

    monkeypatch.setattr(scanner_mod, "TAIL_WORKER_CELLS", 1)  # this small tail too
    c, pats = _tail_corpus(30_000, 3, [32, 50], 970)
    sc = apm_torch.Scanner(pats, 3, ApmConfig(device="cpu", block_windows=1024,
                                              chunk_bytes=chunk_bytes))
    started, waited = threading.Event(), []
    real_tail, real_launch = native.banded_count_set, Scanner._launch_chunk

    def tail(*a, **kw):
        started.set()
        return real_tail(*a, **kw)

    def launch(self, *a, **kw):
        waited.append(started.wait(timeout=60))
        return real_launch(self, *a, **kw)

    monkeypatch.setattr(native, "banded_count_set", tail)
    monkeypatch.setattr(Scanner, "_launch_chunk", launch)
    assert sc.count(c).tolist() == count_matches(c, pats, 3)
    assert waited == [True] * (1 if chunk_bytes > len(c) else 4)


@pytest.mark.parametrize(
    "k,lengths,block_windows",
    [(0, [12, 50], None), (1, [50, 50], 1024), (3, [32, 50], None), (5, [9, 60], 3072)],
)
def test_count_count_batch_and_find_stage_one_layout(monkeypatch, k, lengths, block_windows):
    """``count``, ``count_batch`` and ``find`` of one corpus stage rows of
    the same ``(wf, halo)``, the plan's, and count as the oracle does."""
    from apm_torch.models import scanner as scanner_mod
    from apm_torch.models.pipeline import make_plan

    layouts = []
    fold = scanner_mod.fold_corpus

    def spy(buf, c0, n_rows, wf, halo, out):
        layouts.append((wf, halo))
        return fold(buf, c0, n_rows, wf, halo, out=out)

    monkeypatch.setattr(scanner_mod, "fold_corpus", spy)
    c = _corpus(20_000, 700 + k, b"ACGT")
    pats = [bytes(c[1000 + 3000 * i : 1000 + 3000 * i + m]) for i, m in enumerate(lengths)]
    sc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", cache_corpus=False,
                                              block_windows=block_windows))
    plan = make_plan(sc, len(c))
    want = count_matches(c, pats, k)
    got = {}
    for name, call in (("count", sc.count), ("count_batch", lambda c: sc.count_batch([c])[0]),
                       ("find", lambda c: [len(p) for p in sc.find(c)])):
        layouts.clear()
        assert list(call(c)) == want, name
        got[name] = set(layouts)
    assert got == dict.fromkeys(got, {(plan.wf, plan.halo)}), got


@pytest.mark.parametrize("block_windows", [None, 128, 384, 1024, 1152, 8192])
def test_every_plan_stages_lane_aligned_rows(block_windows):
    """Every plan stages rows of a multiple of 128 windows with a 128-aligned
    halo of at least 128 bytes (and at least ``m_max + 2k``). So ``apm``'s
    staging checks of its fused kernels hold for every plan, and the routes,
    which read no layout, gate on m_max alone as ``apm`` gates on the
    plan's staging."""
    from apm.ops.corr_fused import fused_eligible as apm_fused_eligible

    from apm_torch.models.pipeline import make_plan, staging
    from apm_torch.ops.corr_fused import fused_eligible

    for k, lengths in ((0, [1]), (0, [97]), (0, [98, 3]), (1, [8, 65]), (3, [32, 50]),
                       (12, [120]), (40, [200])):
        pats = [bytes(_corpus(m, 710 + m, b"ACGT")) for m in lengths]
        sc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=block_windows))
        for n in (1, 700, 70_000, 1 << 22, 1 << 28):
            plan = make_plan(sc, n)
            assert (plan.w, plan.wf, plan.halo) == staging(sc, n)
            assert plan.w == 8 * plan.wf and plan.wf % 128 == 0, (k, lengths, n)
            assert plan.halo % 128 == 0 and plan.halo >= max(128, sc.m_max + 2 * k)
            assert fused_eligible(sc.m_max) == apm_fused_eligible(sc.m_max, plan.wf, plan.halo)
