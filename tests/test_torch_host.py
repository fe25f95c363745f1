"""The port's host layer against apm's: oracle, pattern packing, staging,
block planning, routing gates, table construction, make_plan, load_tables,
and the JAX-free import of the port.

Every output compared here is an integer or an exact ±1/0 table, so the
tolerance is 0 throughout.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import apm
from apm import ApmConfig as JaxConfig

import apm_torch
from apm_torch import ApmConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(n, seed, alphabet=b"ACGT\n"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


def _patterns(lengths, seed, alphabet=b"ACGT"):
    return [bytes(_corpus(m, seed + i, alphabet)) for i, m in enumerate(lengths)]


@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_oracle_matches_apm(k):
    from apm.utils import oracle as jo
    from apm_torch.utils import oracle as to

    c = _corpus(3000, 1 + k)
    pats = [bytes(c[100:113]), b"ACGTT", bytes(c[2990:])]
    assert to.count_matches(c, pats, k) == jo.count_matches(c, pats, k)
    for p in pats:
        assert np.array_equal(
            to.banded_distances(c, p, k), jo.banded_distances(c, p, k)
        )
    assert to.count_matches_reference(c[:200], pats[:2], k) == (
        jo.count_matches_reference(c[:200], pats[:2], k)
    )


@pytest.mark.parametrize("k", [0, 3])
def test_pattern_set_packed_matches_apm(k):
    from apm.utils.io import PatternSet as JP
    from apm_torch.utils.io import PatternSet as TP

    pats = [b"GATTACA", b"AC", bytes(range(1, 40))]
    a, b = JP.from_patterns(pats), TP.from_patterns(pats)
    assert np.array_equal(a.table, b.table) and a.raw == b.raw
    for x, y in zip(a.packed(k), b.packed(k)):
        assert np.array_equal(x, y) and x.dtype == y.dtype


@pytest.mark.parametrize(
    "n,offset,n_rows,wf,halo",
    [(5000, 0, 8, 512, 128), (5000, 1024, 8, 512, 128), (300, 0, 4, 128, 256)],
)
def test_fold_corpus_matches_apm(n, offset, n_rows, wf, halo):
    from apm.ops.common import fold_corpus as jfold
    from apm_torch.ops.common import fold_corpus as tfold

    c = _corpus(n, 7)
    want = jfold(c, offset, n_rows, wf, halo)
    assert np.array_equal(tfold(c, offset, n_rows, wf, halo), want)
    out = np.full((n_rows, wf + halo), 0xFF, np.uint8)
    assert tfold(c, offset, n_rows, wf, halo, out=out) is out
    assert np.array_equal(out, want)


def test_block_windows_and_tiers_match_apm():
    from apm.ops import corr_engine as jce, filter_kernel as jfk
    from apm.parallel.plan import choose_block_windows as jcbw
    from apm_torch.ops import corr_engine as tce, filter_kernel as tfk
    from apm_torch.parallel.plan import choose_block_windows as tcbw

    for nw in (0, 1000, 70_000, 1 << 26):
        for p in (1, 2, 8, 64):
            for k in (0, 1, 5, 12):
                assert tcbw(nw, 50, p, k) == jcbw(nw, 50, p, k)
    for m in range(0, 130, 3):
        for k in range(0, 18):
            assert tfk.tier_of(m, k) == jfk.tier_of(m, k)
    plens = (9, 17, 24, 33, 50, 64, 80, 0)
    for k in (0, 1, 2, 5, 9, 16):
        for engine in ("auto", "filter", "dp"):
            assert tfk.partition_plens(plens, k, engine) == (
                jfk.partition_plens(plens, k, engine)
            )
        for c in (1, 4, 16, 17):
            assert tce.fp1_conv_eligible(plens, k, c) == (
                jce.fp1_conv_eligible(plens, k, c)
            )
            for auto in (False, True):
                for m_max in (10, 48, 97, 512, 513):
                    assert tce.corr_eligible(plens, c, m_max, k, auto) == (
                        jce.corr_eligible(plens, c, m_max, k, auto)
                    )


@pytest.mark.parametrize(
    "lengths,alphabet",
    [([14, 50, 3], b"ACGT"), ([33] * 27, b"ACGT"), ([20] * 33, b"ACGT"),
     ([80, 97], b"ACGTN"), ([12, 32], b"\x00\x01")],
)
def test_build_fused_tables_matches_apm(lengths, alphabet):
    from apm.ops.corr_engine import build_alphabet as jalph
    from apm.ops.corr_fused import build_fused_tables as jbuild
    from apm_torch.ops.corr_engine import build_alphabet
    from apm_torch.ops.corr_fused import (
        build_fused_tables, decode_fused_tables, pick_s,
    )

    pats = _patterns(lengths, 40, alphabet)
    m_max = max(lengths)
    pat_raw = np.zeros((len(pats), m_max), np.uint8)
    for i, p in enumerate(pats):
        pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)
    assert np.array_equal(alph, jalph(pats))
    km, thr = build_fused_tables(pat_raw, lengths, alph)
    jkm, jthr = jbuild(pat_raw, lengths, alph)
    assert km.dtype == (np.int8 if jkm.dtype == np.int8 else np.float32)
    assert np.array_equal(km.astype(np.float32), np.asarray(jkm, np.float32))
    assert np.array_equal(thr, jthr) and thr.dtype == jthr.dtype
    # the kernel's pattern bytes come back out of the tables
    pat, plen = decode_fused_tables(km, thr, alph, pick_s(m_max))
    assert plen[: len(pats)].tolist() == lengths
    assert not plen[len(pats) :].any()
    for i, p in enumerate(pats):
        assert pat[i, : len(p)].tobytes() == p


def test_decode_fused_tables_rejects_inconsistent_tables():
    from apm_torch.ops.corr_fused import build_fused_tables, decode_fused_tables

    pats = _patterns([20, 30], 3)
    pat_raw = np.zeros((2, 30), np.uint8)
    for i, p in enumerate(pats):
        pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = np.unique(pat_raw[pat_raw > 0])
    km, thr = build_fused_tables(pat_raw, [20, 30], alph)
    bad = km.copy()
    bad[5, 3 * 2 + 1] *= -1  # phase 3 of slot 1 no longer phase 0 shifted
    with pytest.raises(ValueError):
        decode_fused_tables(bad, thr, alph, 64)


def _plan_fields(plan):
    d = dataclasses.asdict(plan)
    d.pop("backend")
    return d


PLAN_CASES = [
    ([10], b"ACGT"),
    ([32, 50], b"ACGT"),
    ([9, 17, 24, 33], b"ACGT"),
    ([50, 50, 64, 120], b"ACGT"),
    ([40, 12], b"ACDEFGHIKLMNPQRSTVWY"),  # alphabet > 16: no correlation
]


@pytest.mark.parametrize("lengths,alphabet", PLAN_CASES)
def test_make_plan_matches_apm(lengths, alphabet):
    from apm.models.pipeline import make_plan as jplan
    from apm_torch.models.pipeline import make_plan as tplan

    pats = _patterns(lengths, 11, alphabet)
    for k in (0, 1, 2, 5, 9):
        for engine in ("auto", "dp", "corr"):
            jsc = apm.Scanner(
                pats, k, JaxConfig(backend="pallas", interpret=True, engine=engine)
            )
            tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", engine=engine))
            for n in (700, 70_000, 1 << 22):
                try:
                    want = jplan(jsc, n, "pallas")
                except ValueError:
                    with pytest.raises(ValueError):
                        tplan(tsc, n)
                    continue
                assert _plan_fields(tplan(tsc, n)) == _plan_fields(want), (
                    lengths, k, engine, n,
                )


def _apm_tables(sc):
    out = {
        "pat": sc._pat,
        "plen": sc._plen,
        "pat_raw": sc._pat_raw,
        "alphabet": sc._corr_alphabet(),
    }
    if sc.m_max <= 97:
        km, thr = sc._corr_fused_tables()
        out["km"] = np.asarray(km, np.float32) if km.dtype != np.int8 else np.asarray(km)
        out["thr"] = np.asarray(thr)
    return out


@pytest.mark.parametrize("k", [0, 2])
def test_load_tables_round_trips_apm_scanner(k):
    pats = _patterns([32, 50], 21) + _patterns([50], 22)
    jsc = apm.Scanner(pats, k, JaxConfig(backend="pallas", interpret=True))
    arrays = _apm_tables(jsc)
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu"))
    own = tsc.tables()
    # the port's own tables equal apm's
    assert sorted(own) == sorted(arrays)
    for name, a in arrays.items():
        assert np.array_equal(own[name], a) and own[name].dtype == a.dtype, name
    c = _corpus(20_000, 23, b"ACGT")
    c[500:550] = np.frombuffer(pats[1], np.uint8)
    before = tsc.count(c).tolist()
    tsc.load_tables(arrays)
    assert tsc.count(c).tolist() == before
    with pytest.raises(ValueError):
        tsc.load_tables({**arrays, "pat": arrays["pat"][:, 1:]})


def test_port_imports_without_jax():
    """The card's machine has no JAX: the port and chip_smoke.py import
    with JAX made unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import apm_torch, apm_torch.cli, chip_smoke\n"
        "import apm_torch.ops.dp_kernel, apm_torch.ops.corr_fused\n"
        "import apm_torch.ops._build\n"
        "assert 'apm' not in sys.modules, 'the port imported apm'\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
