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
    assert tsc._routes(plan) == ("fused", None)


def test_scanner_long_patterns_k0_route_to_conv():
    # 97 < m_max <= 512 at k = 0 under engine='auto': past the fused
    # kernel, apm runs its XLA conv; the port runs the same conv in conv1d
    from apm_torch.models.pipeline import make_plan

    c = _corpus(20_000, 8, b"ACGT")
    pats = [bytes(c[100:220]), bytes(c[5000:5010])]
    tsc = _three_way(c, pats, 0)
    plan = make_plan(tsc, len(c))
    assert plan.use_corr
    assert tsc._routes(plan) == ("conv", None)


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
    corr, fp1 = tsc._routes(make_plan(tsc, len(c)))
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


@pytest.mark.parametrize(
    "k, engine, names",
    [
        (0, "auto", {"fingerprint", "fold", "copy", "corr", "fetch", "EOF tail"}),
        (2, "dp", {"fingerprint", "fold", "copy", "dp", "fetch", "EOF tail"}),
        (3, "auto", {"fingerprint", "fold", "copy", "phase 1", "phase 2", "fetch",
                     "finalize", "EOF tail"}),
    ],
)
def test_scanner_spans_name_each_phase(k, engine, names):
    """Meter.trace leaves the scan's phase spans in meter.last_spans, and
    changes no count. A repeated corpus is a device cache hit, whose spans
    hold no fold and no copy; with the cache emptied the call stages
    again."""
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
    assert set(sc.meter.last_spans) == names - {"fold", "copy"}
    sc._dev_cache.clear()
    assert sc.count(c).tolist() == off
    assert set(sc.meter.last_spans) == names
    assert all(ms >= 0 for ms in sc.meter.last_spans.values())
