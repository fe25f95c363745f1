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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus(n, seed, alphabet=b"ACGT\n"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


def _patterns(lengths, seed, alphabet=b"ACGT"):
    return [bytes(_corpus(m, seed + i, alphabet)) for i, m in enumerate(lengths)]


@pytest.mark.parametrize("k", [0, 1, 2, 4, 11, 40])
def test_oracle_matches_apm(k):
    # k = 11 and 40 pass some or all of the pattern lengths (13, 5, 10):
    # the port's band keeps min(k, m) diagonals a side, apm's all k
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


@pytest.mark.parametrize("n,n_pad,halo", [(5000, 5120, 12), (0, 1024, 50), (1023, 1024, 0)])
def test_pad_corpus_and_cap_match_apm(n, n_pad, halo):
    from apm.ops.common import cap_for as jcap, pad_corpus as jpad
    from apm_torch.ops.common import cap_for as tcap, pad_corpus as tpad

    c = _corpus(n, 8)
    got, want = tpad(c, n_pad, halo), jpad(c, n_pad, halo)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert [tcap(k) for k in range(20)] == [jcap(k) for k in range(20)]


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


def test_piece_tables_and_shift_ranges_match_apm():
    from apm.ops import filter_kernel as jfk
    from apm_torch.ops import filter_kernel as tfk

    for k in range(0, 17):
        assert tfk.banded_j(k) == jfk.banded_j(k)
        for m in range(1, 200, 7):
            assert tfk.pieces_of(m, k) == jfk.pieces_of(m, k)
            tier = tfk.tier_of(m, k)
            if tier is None:
                continue
            j, kp = tier
            tab = tfk.pieces_of_j(m, j)
            assert tab == jfk.pieces_of_j(m, j)
            for idx, (o, li) in enumerate(tab):
                assert tfk.shift_range(o, li, m, k) == jfk.shift_range(o, li, m, k)
                assert tfk.piece_shift_range(idx, j, o, li, m, k, kp) == (
                    jfk.piece_shift_range(idx, j, o, li, m, k, kp)
                )


def test_phase2_sizing_matches_apm():
    from apm.models import pipeline as jpipe
    from apm.ops import fused as jfused
    from apm_torch.models import pipeline as tpipe
    from apm_torch.ops import fused as tfused

    for name in ("MAX_HOT", "MAX_CLIP", "MAX_HOT_CAP", "OVERFLOW_BATCH", "OVERFLOW_CAP"):
        assert getattr(tfused, name) == getattr(jfused, name), name
    for n_rows in (1, 8, 40, 512, 4096, 32768):
        for wf in (128, 1024, 8192):
            for plens in ((32, 50, 0), (50,) * 6, (120, 120), (10,) * 64):
                for k in (1, 2, 4, 8, 16):
                    assert tfused.pick_max_hot(n_rows, wf, plens, k) == (
                        jfused.pick_max_hot(n_rows, wf, plens, k)
                    )
            for hot in (0, 1, 63, 64, 65, 2000):
                for bound in (1000, n_rows * wf):
                    assert tpipe.candidate_density_dense(hot, wf, bound) == (
                        jpipe.candidate_density_dense(hot, wf, bound)
                    )


def test_conv_phase1_tables_match_apm():
    from apm.ops import corr_engine as jce
    from apm_torch.ops import corr_engine as tce

    for n0 in range(0, 70):
        assert tce.pick_stride(n0) == jce.pick_stride(n0)
    for L in (128, 1152, 8320):
        for c in (1, 2, 4, 5, 16):
            for n_rows in (1, 8, 100, 32768):
                assert tce._group_rows(L, c, n_rows) == jce._group_rows(L, c, n_rows)
    for lengths, k, alphabet in [
        ([32, 50], 1, b"ACGT"), ([50] * 6, 4, b"ACGT"), ([64, 40], 2, b"ACGTN"),
        ([30, 30], 2, b"\x00\xff"),
    ]:
        pats = _patterns(lengths, 60 + k, alphabet)
        m_max = max(lengths)
        pat_raw = np.zeros((8, m_max), np.uint8)
        for i, p in enumerate(pats):
            pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens = tuple(lengths) + (0,) * (8 - len(lengths))
        alph = tce.build_alphabet(pats)
        n_pieces = sum(k + 1 for _ in lengths)
        for stride in (1, tce.pick_stride(n_pieces)):
            got = tce.build_piece_kernel(pat_raw, plens, k, alph, stride=stride)
            want = jce.build_piece_kernel(pat_raw, plens, k, alph, stride=stride)
            assert got[0].dtype == np.float32
            for g, w in zip(got, want):
                assert np.array_equal(g, np.asarray(w, np.float32)), (lengths, k, stride)
        kern = np.random.default_rng(k).integers(-1, 2, (7, 2, 3)).astype(np.float32)
        thr = np.arange(3, dtype=np.float32)
        for stride in (1, 4):
            for g, w in zip(tce._fold_shifts(kern, thr, stride), jce._fold_shifts(kern, thr, stride)):
                assert np.array_equal(g, w)


def test_myers_gate_and_peq_match_apm():
    import jax.numpy as jnp

    from apm.ops import pallas_kernel as jpk
    from apm_torch.ops import dp_kernel as tdk

    for name in ("MYERS_KMIN_AUTO", "MYERS_KMAX", "MYERS_CMAX", "MYERS_SMEM_MAX"):
        assert getattr(tdk, name) == getattr(jpk, name), name
    alphabets = [(), (65,), tuple(b"ACGT"), tuple(b"ACGTNRYK"), tuple(b"ACGTNRYKM")]
    for k in range(0, 17):
        for alph in alphabets:
            for impl in ("auto", "band", "myers"):
                for p, m_max in ((8, 50), (8, k), (64, 50), (256, 50), (8, 300)):
                    for dtype in ("int32", "int16"):
                        args = (k, alph, dtype, impl, p, m_max)
                        assert tdk._myers_mode(*args) == jpk._myers_mode(*args), args
                        assert tdk.resolve_dp_mode(*args) == jpk.resolve_dp_mode(*args)
    rng = np.random.default_rng(5)
    for k, alph in ((1, b"AC"), (3, b"ACGT"), (14, b"ACGTNRYK")):
        a = np.frombuffer(alph, np.uint8)
        pat = a[rng.integers(0, len(a), (8, 40 + 2 * k))]
        pat[5:] = 0  # padding rows
        got = tdk.build_peq(pat, k, 40, tuple(alph))
        want = np.asarray(jpk._build_peq(jnp.asarray(pat), k, 40, tuple(alph)))
        assert got.dtype == np.int32 and np.array_equal(got, want)


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
    if "routes" in d:  # the port's plan: apm's two route flags, from its routes
        d.pop("routes")
        d.update(use_corr=plan.use_corr, fp1_conv=plan.fp1_conv)
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
        for engine in ("auto", "dp", "corr", "filter"):
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
    """The tables an ``apm.Scanner`` builds, as NumPy arrays under the names
    ``apm_torch.Scanner.load_tables`` takes: the correlation tables, the
    conv phase 1 piece tables when its ``engine="auto"`` plan runs that
    phase, and the Myers PEQ table when the bit-parallel band can
    represent the pattern table."""
    import jax.numpy as jnp

    from apm.models.pipeline import make_plan
    from apm.ops.pallas_kernel import _build_peq, _myers_mode

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
    plan = make_plan(sc, 1 << 20, "pallas")
    if plan.fp1_conv:
        kern, thr, owner, stride = sc._fp1_kernel(plan.plens_filter)
        out["pkern"] = np.asarray(kern, np.float32)
        out["pthr"], out["owner"] = np.asarray(thr), np.asarray(owner)
        out["stride"] = np.asarray(stride, np.int64)
    alph = sc._dp_alphabet()
    if _myers_mode(sc.k, alph, "int32", "myers", sc._pat.shape[0], sc.m_max):
        out["peq"] = np.asarray(_build_peq(jnp.asarray(sc._pat), sc.k, sc.m_max, alph))
    return out


@pytest.mark.parametrize("k", [0, 2, 3, 4])
def test_load_tables_round_trips_apm_scanner(k):
    # k = 2 and 4 run conv phase 1 (piece tables), k = 3 the shift-OR
    # filter; k >= 2 carries the PEQ table (kernel C at k >= 3)
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
    c[9_000:9_050] = np.frombuffer(pats[2], np.uint8)
    c[9_010] = c[9_010] ^ 2  # one substitution
    before = tsc.count(c).tolist()
    assert before == count_matches(c, pats, k)
    tsc.load_tables(arrays)
    assert tsc.count(c).tolist() == before
    with pytest.raises(ValueError):
        tsc.load_tables({**arrays, "pat": arrays["pat"][:, 1:]})
    if "peq" in arrays:
        with pytest.raises(ValueError):
            tsc.load_tables({**arrays, "peq": arrays["peq"][1:]})


def test_load_tables_piece_tables_drive_conv_phase1():
    # the port's conv phase 1 reads the loaded piece tables: with every
    # piece blanked no row is a candidate, and only the EOF tail (counted
    # on the host) is left
    pats = _patterns([50, 50, 50, 50, 50, 50], 31)
    k = 4
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=1024))
    c = _corpus(30_000, 32, b"ACGT")
    c[700:750] = np.frombuffer(pats[0], np.uint8)
    arrays = tsc.tables()
    assert "pkern" in arrays
    assert tsc.count(c).tolist() == count_matches(c, pats, k)
    assert tsc.last_filtration["route"] == "device-verify"
    tsc.load_tables({**arrays, "pkern": np.zeros_like(arrays["pkern"])})
    tail = tsc.tail_counts(c, tsc.device_window_bound(len(c)))
    assert tsc.count(c).tolist() == tail.tolist()
    assert tsc.last_filtration["route"] == "zero-candidates"


def test_port_imports_without_jax():
    """The card's machine has no JAX: every module of the port, and
    chip_smoke.py and chip_compare.py, import with JAX made unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import importlib, pkgutil\n"
        "import apm_torch, chip_smoke, chip_compare\n"
        "names = [m.name for m in pkgutil.walk_packages(apm_torch.__path__, 'apm_torch.')\n"
        "         if m.name != 'apm_torch.__main__']  # runs the CLI\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'apm_torch.ops.fused', 'apm_torch.models.scanner', 'apm_torch.cli',\n"
        "        'apm_torch.graft_entry', 'apm_torch.ops.torch_engine'} <= set(names)\n"
        "assert not [m for m in sys.modules if m == 'apm' or m.startswith('apm.')], 'the port imported apm'\n"
        "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
