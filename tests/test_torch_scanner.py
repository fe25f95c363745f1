"""The port's Scanner end to end on the CPU against apm and the oracle.

``apm_torch.Scanner(..., ApmConfig(device="cpu"))`` (plain PyTorch
versions of the kernels), ``apm.Scanner`` (its Pallas kernels in interpret
mode) and ``apm.utils.oracle.count_matches`` must give the same counts —
integers, tolerance 0. Also: the routing decisions of this slice, and the
options the port refuses instead of degrading quietly.
"""

import numpy as np
import pytest

import apm
from apm import ApmConfig as JaxConfig
from apm.utils.oracle import count_matches

import apm_torch
from apm_torch import ApmConfig


def _corpus(n, seed, alphabet=b"ACGT\n"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


def _three_way(corpus, pats, k, engine="auto"):
    want = count_matches(corpus, pats, k)
    jsc = apm.Scanner(
        pats, k,
        JaxConfig(backend="pallas", interpret=True, block_windows=1024,
                  engine=engine),
    )
    tsc = apm_torch.Scanner(
        pats, k, ApmConfig(device="cpu", block_windows=1024, engine=engine)
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
    assert tsc._routes(plan) == (True, tuple(0 for _ in plan.plens_corr))


def test_scanner_long_patterns_k0_route_to_dp():
    # 97 < m_max <= 512 at k = 0: apm's XLA conv is not ported; under
    # engine='auto' the banded-DP path counts these exactly.
    from apm_torch.models.pipeline import make_plan

    c = _corpus(20_000, 8, b"ACGT")
    pats = [bytes(c[100:220]), bytes(c[5000:5010])]
    tsc = _three_way(c, pats, 0)
    plan = make_plan(tsc, len(c))
    assert plan.use_corr
    assert tsc._routes(plan) == (False, plan.plens_corr)


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


@pytest.mark.parametrize(
    "cfg,k,pats,exc",
    [
        (dict(engine="filter"), 1, [b"ACGTACGTACGTACGTACGT"], NotImplementedError),
        (dict(dp_impl="myers"), 3, [b"ACGTACGTAC"], NotImplementedError),
        (dict(dp_dtype="int16"), 1, [b"ACGTACGTAC"], NotImplementedError),
        (dict(strategy="database_over_devices"), 0, [b"ACGT"], NotImplementedError),
        (dict(strategy="patterns_over_devices"), 0, [b"ACGT"], NotImplementedError),
        (dict(max_devices=2), 0, [b"ACGT"], NotImplementedError),
    ],
)
def test_scanner_refuses_unported_options(cfg, k, pats, exc):
    with pytest.raises(exc, match="ROADMAP|int32"):
        apm_torch.Scanner(pats, k, ApmConfig(device="cpu", **cfg))


@pytest.mark.parametrize(
    "cfg,exc",
    [
        (dict(corr_impl="conv"), NotImplementedError),
        (dict(engine="corr", corr_impl="fused"), ValueError),
        (dict(engine="corr"), NotImplementedError),
    ],
)
def test_scanner_refuses_unported_correlation_routes(cfg, exc):
    c = _corpus(5_000, 10, b"ACGT")
    long_pat = [bytes(c[100:220])]  # m_max 120: past the fused kernel
    pats = long_pat if "engine" in cfg else [bytes(c[100:150])]
    sc = apm_torch.Scanner(pats, 0, ApmConfig(device="cpu", **cfg))
    with pytest.raises(exc):
        sc.count(c)
