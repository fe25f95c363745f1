"""Kernel #7's plain version and the corr_impl="fused" route at k >= 1,
held against apm (Pallas in interpret mode) and the oracle.

Kernel level: ``scan_pieces_fused_ref`` (and the ``scan_pieces_fused``
wrapper, which takes it for CPU tensors) against
``apm.ops.corr_fused.scan_pieces_fused(interpret=True)`` on the same staged
rows and piece tables: ``fcnt`` and ``rowmap`` cell for cell, at k = 1, 2
and 4, with slot padding (> 24 pieces), int8 tables (>= 32 pieces),
``start > 0``, a mid-row bound, ``n_rows < R`` and a pattern that holds a
NUL byte. apm sums the rows in float32, so every case keeps its totals far
below 2**24. Table level: the piece tables equal apm's and decode back to
their pieces. Entry level: ``Scanner.count`` under ``corr_impl="fused"``,
port == apm == oracle, and the route that launches the piece scan. Every
output is an integer: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

import apm
from apm import ApmConfig as JaxConfig
from apm.utils.oracle import count_matches

import apm_torch
from apm_torch import ApmConfig
from apm_torch.ops import corr_fused, fused
from apm_torch.ops.corr_engine import build_alphabet, n_bitplanes
from apm_torch.ops.filter_kernel import tier_of
from apm_torch.utils.corpus import plant


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
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


def _rows_of(corpus, wf, halo, n_rows):
    rows = np.zeros((n_rows, wf + halo), np.uint8)
    for r in range(n_rows):
        seg = corpus[r * wf : r * wf + wf + halo]
        rows[r, : len(seg)] = seg
    return rows


def _table(pats, k, p_pad=None):
    """Raw table and the filtration lengths (ineligible patterns 0), as the
    Scanner passes them, padded to a multiple of 8 rows."""
    p_pad = p_pad or max(8, -(-len(pats) // 8) * 8)
    m_max = max(len(p) for p in pats)
    raw = np.zeros((p_pad, m_max), np.uint8)
    plens = [0] * p_pad
    for i, p in enumerate(pats):
        raw[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens[i] = len(p) if tier_of(len(p), k) else 0
    return raw, tuple(plens)


def _both(rows, pats, k, bound, start, wf, halo, n_rows):
    """(apm's (fcnt, rowmap), the port's) on the same rows and tables."""
    import jax.numpy as jnp

    from apm.ops.corr_fused import build_fused_piece_tables as jbuild
    from apm.ops.corr_fused import pick_g, scan_pieces_fused

    raw, plens = _table(pats, k)
    alph = build_alphabet(pats)
    km, thr, owner64 = corr_fused.build_fused_piece_tables(raw, plens, k, alph)
    jkm, jthr, jowner = jbuild(raw, plens, k, alph)
    assert np.array_equal(km.astype(np.float32), np.asarray(jkm, np.float32))
    assert km.dtype == (np.int8 if jkm.dtype == np.int8 else np.float32)
    assert np.array_equal(thr, jthr) and thr.dtype == jthr.dtype
    assert np.array_equal(owner64, jowner)
    n_slots = km.shape[1] // corr_fused.S_FUSED
    l128 = (wf + halo) // 128
    fc, rm = scan_pieces_fused(
        jnp.asarray(rows), jnp.asarray(jkm), jnp.asarray(jthr), jnp.asarray(jowner),
        jnp.asarray(alph), jnp.asarray(bound, jnp.int32), jnp.asarray(start, jnp.int32),
        wf=wf, l128=l128, n_rows=n_rows, g=pick_g(n_rows, l128, n_slots),
        n_slots=n_slots, p_pat=raw.shape[0], c_alpha=len(alph),
        b_planes=n_bitplanes(len(alph)), interpret=True,
    )
    tabs = corr_fused.PieceTables.from_numpy(km, thr, owner64, alph, "cpu")
    r = torch.from_numpy(rows)
    kw = dict(wf=wf, halo=halo, n_rows=n_rows)
    got = corr_fused.scan_pieces_fused_ref(r, tabs, bound, start, **kw)
    wrapped = corr_fused.scan_pieces_fused(r, tabs, bound, start, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, wrapped))
    assert got[0].dtype == got[1].dtype == torch.int32
    return (np.asarray(fc), np.asarray(rm)), (got[0].numpy(), got[1].numpy()), n_slots


def _planted(n, seed, pats, step, alphabet=b"ACGT"):
    c = _corpus(n, seed, alphabet)
    for i, p in enumerate(pats):
        for pos in range(100 + 37 * i, n - len(p), step):
            c[pos : pos + len(p)] = np.frombuffer(p, np.uint8)
    return c


@pytest.mark.parametrize("k", [1, 2, 4])
def test_pieces_ref_matches_apm(k):
    # the reference-shaped set (a 32-mer and 50-mers; at k = 4 the 32-mer is
    # not filtration-eligible and has no pieces), start > 0, a mid-row
    # bound and a staging-padding row
    wf, halo, n_rows = 512, 128, 13
    pats = [bytes(_corpus(32, 10)), bytes(_corpus(50, 11)), bytes(_corpus(50, 12))]
    c = _planted((n_rows + 4) * wf + halo, 13 + k, pats, 1700)
    rows = _rows_of(c[3 * wf :], wf, halo, n_rows)
    start = 3 * wf
    bound = start + (n_rows - 3) * wf + 211
    (jf, jr), (tf, tr), _ = _both(rows, pats, k, bound, start, wf, halo, n_rows - 1)
    assert tf.tolist() == jf.tolist() and np.array_equal(tr, jr)
    assert tf.sum() > 0 and tr[n_rows - 2 :].sum() == 0  # rows past the bound
    assert 0 < tr.sum() < tr.size


@pytest.mark.parametrize(
    "k,lengths,int8,padded",
    [
        (2, [30] * 9, False, True),  # 27 pieces: 64 * 27 > 1536, padded to 28
        (1, [20] * 17, True, False),  # 34 pieces: int8 tables
        (2, [40] * 11, True, True),  # 33 pieces: int8 and padded to 34
    ],
)
def test_pieces_ref_matches_apm_wide(k, lengths, int8, padded):
    wf, halo, n_rows = 512, 128, 9
    pats = [bytes(_corpus(m, 40 + i)) for i, m in enumerate(lengths)]
    c = _planted(n_rows * wf + halo, 50 + k, pats, 911)
    rows = _rows_of(c, wf, halo, n_rows)
    raw, plens = _table(pats, k)
    alph = build_alphabet(pats)
    km, _, _ = corr_fused.build_fused_piece_tables(raw, plens, k, alph)
    n_pieces = sum(tier_of(m, k)[0] for m in lengths)
    assert (km.dtype == np.int8) == int8
    assert (km.shape[1] // 64 == n_pieces + 1) == padded
    (jf, jr), (tf, tr), n_slots = _both(rows, pats, k, n_rows * wf - 40, 0, wf, halo, n_rows)
    assert n_slots == km.shape[1] // 64
    assert tf.tolist() == jf.tolist() and np.array_equal(tr, jr)
    assert tf[: len(pats)].min() > 0


def test_pieces_ref_nul_pattern_and_padding_rows():
    # NUL is in the alphabet: the zero padding past EOF matches a NUL piece,
    # and only the n_rows mask keeps the staging-padding rows silent
    wf, halo, n_rows = 512, 128, 6
    a = np.frombuffer(b"\x00\x01\x02", np.uint8)
    rng = np.random.default_rng(60)
    c = a[rng.integers(0, 3, size=n_rows * wf - 300)]
    pats = [b"\x00" * 30, bytes(c[700:750])]
    rows = _rows_of(c, wf, halo, n_rows + 3)  # three zero padding rows
    (jf, jr), (tf, tr), _ = _both(rows, pats, 1, len(c) - 49, 0, wf, halo, n_rows)
    assert tf.tolist() == jf.tolist() and np.array_equal(tr, jr)
    assert tr[n_rows - 1, 0] == 1 and tr[n_rows:].sum() == 0


def test_piece_tables_decode_round_trip():
    pats = [bytes(_corpus(32, 70)), bytes(_corpus(50, 71)), bytes(_corpus(64, 72))]
    for k in (1, 2):
        raw, plens = _table(pats, k)
        alph = build_alphabet(pats)
        km, thr, owner64 = corr_fused.build_fused_piece_tables(raw, plens, k, alph)
        piece, plen, owner = corr_fused.decode_fused_piece_tables(km, thr, owner64, alph)
        from apm_torch.ops.filter_kernel import pieces_of_j

        want = [
            (pi, raw[pi, off : off + length].tobytes())
            for pi, m in enumerate(plens) if m
            for off, length in pieces_of_j(m, tier_of(m, k)[0])
        ]
        assert len(plen) >= len(want) and not plen[len(want) :].any()
        assert (owner[len(want) :] == -1).all()
        got = [(int(o), piece[q, : plen[q]].tobytes()) for q, o in enumerate(owner[: len(want)])]
        assert got == want
        tabs = corr_fused.PieceTables.from_numpy(km, thr, owner64, alph, "cpu")
        assert tabs.groups == ((0, len(want), 0, len(pats)),) and tabs.n_pat == 8
        bad = km.astype(np.float32).copy()
        bad[7, 5 * (km.shape[1] // 64) + 1] *= -1  # phase 5 of slot 1, byte 2
        with pytest.raises(ValueError):
            corr_fused.decode_fused_piece_tables(bad, thr, owner64, alph)
        two_owners = owner64.copy()
        two_owners[:, 7] = 1.0
        with pytest.raises(ValueError):
            corr_fused.decode_fused_piece_tables(km, thr, two_owners, alph)


def test_piece_groups_split_by_slots_and_patterns(monkeypatch):
    monkeypatch.setattr(corr_fused, "_PIECE_GROUP", 4)
    monkeypatch.setattr(corr_fused, "_PAT_GROUP", 2)
    plen = np.array([5, 5, 5, 5, 5, 5, 0], np.int32)
    owner = np.array([0, 0, 0, 1, 2, 2, -1], np.int32)
    assert corr_fused._piece_groups(plen, owner) == ((0, 4, 0, 2), (4, 6, 2, 3))


def test_pieces_wrapper_checks_its_inputs():
    pats = [bytes(_corpus(50, 80))]
    raw, plens = _table(pats, 1)
    alph = build_alphabet(pats)
    tabs = corr_fused.PieceTables.from_numpy(
        *corr_fused.build_fused_piece_tables(raw, plens, 1, alph), alph, "cpu"
    )
    rows = torch.zeros((4, 640), dtype=torch.uint8)
    with pytest.raises(ValueError):
        corr_fused.scan_pieces_fused(rows[:, 1:], tabs, 100, 0, wf=512, halo=128, n_rows=4)
    with pytest.raises(ValueError, match="halo"):
        corr_fused.scan_pieces_fused(rows, tabs, 100, 0, wf=600, halo=40, n_rows=4)
    before = corr_fused.PIECE_LAUNCHES
    corr_fused.scan_pieces_fused(rows, tabs, 100, 0, wf=512, halo=128, n_rows=4)
    assert corr_fused.PIECE_LAUNCHES == before


def _three_way(c, pats, k, **cfg):
    want = count_matches(c, pats, k)
    jsc = apm.Scanner(pats, k, JaxConfig(backend="pallas", interpret=True, block_windows=1024, **cfg))
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=1024, **cfg))
    got_t = tsc.count(c).tolist()
    assert got_t == want, ("port", got_t, want)
    assert jsc.count(c).tolist() == want
    return tsc, want


@pytest.mark.parametrize("k", [1, 2, 4])
def test_scanner_fused_phase1_matches_apm_and_oracle(k):
    from apm_torch.models.pipeline import make_plan

    c = _corpus(60_000, 90 + k, b"ACGT\n")
    p32, p50 = bytes(_corpus(32, 91)), bytes(_corpus(50, 92))
    plant(c, np.frombuffer(p50, np.uint8), [1000, 20_000, 41_000], k=k, seed=k)
    plant(c, np.frombuffer(p32, np.uint8), [7000], k=min(k, 1), seed=k)
    tsc, want = _three_way(c, [p32, p50, p50], k, corr_impl="fused")
    routes = make_plan(tsc, len(c)).routes
    assert (routes.corr, routes.fp1) == (None, "fused")
    assert want[1] >= 3 and tsc.last_filtration["route"] == "device-verify"


def test_fused_phase1_only_when_pinned(monkeypatch):
    # apm's tripwire test (tests/test_corr_fused.py): auto runs the piece
    # conv and never the fused piece scan; corr_impl="fused" runs it
    calls = []
    real = fused.filter_verify_chunk

    def spy(rows, phase1, *a, **kw):  # counts the chunks whose phase 1 is kernel #7
        if phase1.func is corr_fused.scan_pieces_fused:
            calls.append(1)
        return real(rows, phase1, *a, **kw)

    monkeypatch.setattr(fused, "filter_verify_chunk", spy)
    c = _corpus(120_000, 20, b"ACGT\n")
    pats = [bytes(c[500:550]), bytes(c[60_000:60_050])]
    want = count_matches(c, pats, 4)
    assert apm_torch.Scanner(pats, 4, ApmConfig(device="cpu")).count(c).tolist() == want
    assert calls == []
    sc = apm_torch.Scanner(pats, 4, ApmConfig(device="cpu", corr_impl="fused"))
    assert sc.count(c).tolist() == want
    assert len(calls) > 0


def test_fused_phase1_gate_falls_back_to_conv():
    # m_max 80 > 65: apm's piece gate fails and conv phase 1 runs, silently
    from apm_torch.models.pipeline import make_plan

    c = _corpus(30_000, 21, b"ACGT\n")
    pats = [bytes(c[300:380]), bytes(c[9000:9050])]
    tsc, _ = _three_way(c, pats, 1, corr_impl="fused")
    routes = make_plan(tsc, len(c)).routes
    assert (routes.corr, routes.fp1) == (None, "conv")
    assert "pieces_km" not in tsc.tables()


def test_load_tables_carries_the_fused_piece_tables():
    # an apm.Scanner's fused piece tables drive the port's piece scan: with
    # every piece blanked to a sentinel no row is a candidate
    from apm_torch.models.pipeline import make_plan

    k = 2
    pats = [bytes(_corpus(50, 95 + i)) for i in range(3)]
    c = _corpus(30_000, 98, b"ACGT")
    c[700:750] = np.frombuffer(pats[0], np.uint8)
    jsc = apm.Scanner(pats, k, JaxConfig(backend="pallas", interpret=True, corr_impl="fused"))
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=1024, corr_impl="fused"))
    km, thr, owner64 = jsc._fp1_fused_tables(make_plan(tsc, len(c)).plens_filter)
    own = tsc.tables()
    assert np.array_equal(own["pieces_km"].astype(np.float32), np.asarray(km, np.float32))
    assert np.array_equal(own["pieces_thr"], thr) and np.array_equal(own["pieces_owner64"], owner64)
    arrays = {**own, "pieces_km": np.asarray(km, np.float32)}
    tsc.load_tables(arrays)
    assert tsc.count(c).tolist() == count_matches(c, pats, k)
    blank_thr = np.full_like(own["pieces_thr"], 2**30)
    blank = {**arrays, "pieces_km": np.zeros_like(arrays["pieces_km"]),
             "pieces_thr": blank_thr, "pieces_owner64": np.zeros_like(owner64)}
    tsc.load_tables(blank)
    tail = tsc.tail_counts(c, tsc.device_window_bound(len(c)))
    assert tsc.count(c).tolist() == tail.tolist()
    assert tsc.last_filtration["route"] == "zero-candidates"
    with pytest.raises(ValueError):
        tsc.load_tables({**arrays, "pieces_km": arrays["pieces_km"][:, 1:]})


@pytest.mark.parametrize("length", range(8, corr_fused.M_MAX_PIECES + 1))
def test_piece_prefix_words_of_every_piece_length(length):
    # exact-tier pieces are at least 8 bytes: the mask keeps all 8 prefix
    # bytes. A k = 0 pattern is one piece of its own length; the NUL byte
    # and the sentinel slot padding the tables to an even count stay exact.
    piece = bytearray(_corpus(length, 900 + length).tobytes())
    piece[3] = 0
    pats = [bytes(piece), bytes(_corpus(40, 901))]
    raw, plens = _table(pats, 0)
    alph = build_alphabet(pats)
    km, thr, owner64 = corr_fused.build_fused_piece_tables(raw, plens, 0, alph)
    tabs = corr_fused.PieceTables.from_numpy(km, thr, owner64, alph, "cpu")
    words = tabs.prefix.numpy().view(np.uint64)
    want = [(int.from_bytes(p[:8], "little"), 2**64 - 1) for p in pats]
    want += [(0, 0)] * (len(words) - len(pats))
    assert [tuple(int(x) for x in row) for row in words] == want
    assert np.array_equal(words, corr_fused.prefix_words(tabs.piece.numpy(), tabs.plen.numpy()))


def test_piece_tables_from_apm_carry_prefix_words():
    # an apm.Scanner's fused piece tables, loaded into the port, give kernel
    # #7 the prefix words of the pieces they hold
    from apm_torch.models.pipeline import make_plan

    k = 1
    pats = [bytes(_corpus(32, 910)), bytes(_corpus(50, 911))]
    jsc = apm.Scanner(pats, k, JaxConfig(backend="pallas", interpret=True, corr_impl="fused"))
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", corr_impl="fused"))
    plens = make_plan(tsc, 1 << 20).plens_filter
    km, thr, owner64 = jsc._fp1_fused_tables(plens)
    tsc.load_tables({**tsc.tables(), "pieces_km": np.asarray(km, np.float32)})
    tabs = tsc._device_fp1_fused(plens)
    words = tabs.prefix.numpy().view(np.uint64)
    got = [(int(o), tuple(int(x) for x in w)) for o, w in zip(tabs.owner.tolist(), words)]
    from apm_torch.ops.filter_kernel import pieces_of_j

    want = [(pi, (int.from_bytes(p[off : off + 8], "little"), 2**64 - 1))
            for pi, p in enumerate(pats) for off, _ in pieces_of_j(len(p), tier_of(len(p), k)[0])]
    assert got[: len(want)] == want and all(w == (0, 0) for _, w in got[len(want):])
