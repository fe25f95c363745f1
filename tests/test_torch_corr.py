"""Kernel B's plain version against apm's fused Pallas correlation kernel.

``scan_corr_fused_ref`` (and the ``scan_corr_fused`` wrapper, which takes
it for CPU tensors) must give exactly the counts of
``apm.ops.corr_fused.scan_corr_fused(..., interpret=True)`` on the same
staged rows and tables, on the cases of ``tests/test_corr_fused.py``.
Counts are integers: tolerance 0. The CUDA kernel is compared with the same
plain version on the card (``chip_smoke.py`` phase 3).

Also ``apm``'s XLA correlation conv at k = 0, which the port computes with
``conv1d`` in float32: ``scan_corr_mxu`` and ``scan_corr_batch`` against
``apm.ops.corr_engine``'s, at stride 1 and > 1, m up to 512, ``p_out``
padding and the NUL-pattern ``n_rows`` mask.
"""

import numpy as np
import pytest
import torch

from apm_torch.ops import corr_fused
from apm_torch.ops.corr_engine import build_alphabet, n_bitplanes


def _rows_of(corpus, wf, halo, n_rows):
    rows = np.zeros((n_rows, wf + halo), np.uint8)
    for r in range(n_rows):
        seg = corpus[r * wf : r * wf + wf + halo]
        rows[r, : len(seg)] = seg
    return rows


def _corpus(n, seed, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


def _both(rows, pats, bound, start, wf, halo, n_rows, p_out=0):
    import jax.numpy as jnp

    from apm.ops.corr_fused import build_fused_tables as jbuild, scan_corr_fused

    plens = [len(p) for p in pats]
    m_max = max(plens)
    pat_raw = np.zeros((len(pats), m_max), np.uint8)
    for i, p in enumerate(pats):
        pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)
    s_ph = corr_fused.pick_s(m_max)
    jkm, jthr = jbuild(pat_raw, plens, alph)
    want = np.asarray(
        scan_corr_fused(
            jnp.asarray(rows), jnp.asarray(jkm), jnp.asarray(jthr),
            jnp.asarray(alph), jnp.asarray(bound, jnp.int32),
            jnp.asarray(start, jnp.int32),
            wf=wf, l128=(wf + halo) // 128, n_rows=n_rows, g=8,
            p=jkm.shape[1] // s_ph, c_alpha=len(alph),
            b_planes=n_bitplanes(len(alph)), s_ph=s_ph, interpret=True,
            p_out=p_out,
        )
    )
    km, thr = corr_fused.build_fused_tables(pat_raw, plens, alph)
    tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, s_ph, "cpu")
    kw = dict(wf=wf, halo=halo, n_rows=n_rows, p_out=p_out)
    r = torch.from_numpy(rows)
    got = corr_fused.scan_corr_fused_ref(r, tabs, bound, start, **kw)
    wrapped = corr_fused.scan_corr_fused(r, tabs, bound, start, **kw)
    assert torch.equal(got, wrapped) and got.dtype == torch.int32
    return want, got.numpy()


def test_corr_ref_basic():
    wf, halo, n_rows = 512, 128, 21
    corpus = _corpus(n_rows * wf + 200, 5)
    pats = [b"ACGTACGTACGTAC", bytes(corpus[3000:3050]), b"TTTTT"]
    for t in range(30):
        pos = (t * 7717) % (len(corpus) - 50)
        pat = pats[t % 3]
        corpus[pos : pos + len(pat)] = np.frombuffer(pat, np.uint8)
    bound = len(corpus) - 50 + 1
    want, got = _both(_rows_of(corpus, wf, halo, n_rows), pats, bound, 0,
                      wf, halo, n_rows, p_out=8)
    assert want.sum() > 0 and got.shape == (8,)
    assert got.tolist() == want.tolist()


def test_corr_ref_wide_p_chunked_and_padded():
    # 27 patterns -> 64*27 > 1536: apm pads the slot count to 28.
    wf, halo, n_rows = 512, 128, 9
    corpus = _corpus(n_rows * wf + 100, 6)
    pats = [bytes(_corpus(33, 100 + i)) for i in range(27)]
    for i, p in enumerate(pats):
        corpus[100 + i * 97 : 100 + i * 97 + 33] = np.frombuffer(p, np.uint8)
    bound = len(corpus) - 33 + 1
    want, got = _both(_rows_of(corpus, wf, halo, n_rows), pats, bound, 0,
                      wf, halo, n_rows)
    assert got.shape == (28,) and want.sum() >= 27
    assert got.tolist() == want.tolist()


def test_corr_ref_bound_clip_and_start():
    wf, halo, n_rows = 512, 128, 13
    corpus = _corpus(n_rows * wf + 100, 7)
    pats = [bytes(corpus[100:140]), bytes(corpus[4100:4130])]
    rows = _rows_of(corpus, wf, halo, n_rows)
    start = 4 * wf
    bound = start + 7 * wf - 333  # mid-row clip
    want, got = _both(rows[4:], pats, bound, start, wf, halo, n_rows - 4)
    assert got.tolist() == want.tolist()


def test_corr_ref_nul_alphabet_padding_mask():
    # NUL is IN the alphabet: zero-filled staging padding rows would alias
    # real symbols; the n_rows mask keeps them silent.
    wf, halo, n_rows = 512, 128, 5
    rng = np.random.default_rng(8)
    a = np.frombuffer(b"\x00\x01", np.uint8)
    corpus = a[rng.integers(0, 2, size=n_rows * wf - 64)]
    pats = [b"\x00" * 12, bytes(corpus[64:96])]
    bound = len(corpus) - 32 + 1
    rows = _rows_of(corpus, wf, halo, n_rows + 3)  # 3 zero padding rows
    want, got = _both(rows, pats, bound, 0, wf, halo, n_rows)
    assert want.sum() > 0
    assert got.tolist() == want.tolist()


def test_corr_ref_int8_wide_p():
    wf, halo, n_rows = 512, 128, 9
    corpus = _corpus(n_rows * wf + 100, 15)
    P = corr_fused._INT8_MIN_SLOTS + 1
    pats = [bytes(_corpus(20, 300 + i)) for i in range(P)]
    for i, p in enumerate(pats):
        corpus[50 + i * 131 : 70 + i * 131] = np.frombuffer(p, np.uint8)
    bound = len(corpus) - 20 + 1
    want, got = _both(_rows_of(corpus, wf, halo, n_rows), pats, bound, 0,
                      wf, halo, n_rows)
    assert want.sum() >= P
    assert got.tolist() == want.tolist()


def test_corr_ref_s32_midlength_patterns():
    wf, halo, n_rows = 512, 128, 17
    corpus = _corpus(n_rows * wf + 200, 16)
    pats = [bytes(corpus[500:580]), bytes(corpus[7_000:7_097])]
    for i, p in enumerate(pats):
        for pos in (1_234 + i * 7, 6_001 + i * 13):
            corpus[pos : pos + len(p)] = np.frombuffer(p, np.uint8)
    assert corr_fused.pick_s(97) == 32
    bound = len(corpus) - 97 + 1
    want, got = _both(_rows_of(corpus, wf, halo, n_rows), pats, bound, 0,
                      wf, halo, n_rows)
    assert want.sum() >= 4
    assert got.tolist() == want.tolist()


def test_corr_wrapper_checks_its_inputs():
    pats = [b"ACGTAC"]
    alph = build_alphabet(pats)
    km, thr = corr_fused.build_fused_tables(
        np.frombuffer(pats[0], np.uint8)[None], [6], alph
    )
    tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, 64, "cpu")
    rows = torch.zeros((4, 640), dtype=torch.uint8)
    kw = dict(wf=512, halo=128, n_rows=4)
    with pytest.raises(ValueError):
        corr_fused.scan_corr_fused(rows[:, 1:], tabs, 100, 0, **kw)
    with pytest.raises(ValueError):
        corr_fused.scan_corr_fused(rows, tabs, 100, 0, **{**kw, "halo": 64, "wf": 576})
    before = corr_fused.LAUNCHES
    corr_fused.scan_corr_fused(rows, tabs, 100, 0, **kw)
    assert corr_fused.LAUNCHES == before


# -- apm's XLA correlation conv at k = 0 (scan_corr_mxu, scan_corr_batch) ----


def _conv_tables(pats, n_pad=None):
    """Port and apm conv tables over the real patterns (as the Scanners
    build them), with the stride each picks; the tables must be equal."""
    from apm.ops.corr_engine import build_kernel as jbuild
    from apm_torch.ops import corr_engine

    plens = [len(p) for p in pats]
    m_max = max(plens)
    raw = np.zeros((len(pats), m_max), np.uint8)
    for i, p in enumerate(pats):
        raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)
    stride = corr_engine.pick_stride(len(pats))
    kern, thr = corr_engine.build_kernel(raw, plens, alph, stride=stride)
    jkern, jthr = jbuild(raw, plens, alph, stride=stride)
    assert kern.dtype == np.float32 and np.array_equal(kern, np.asarray(jkern, np.float32))
    assert np.array_equal(thr, jthr)
    return kern, thr, jkern, jthr, alph, stride, m_max


@pytest.mark.parametrize(
    "lengths,nul",
    [
        ([50, 32], False),  # stride 32 (2 patterns)
        ([120, 20, 64], False),  # stride 32, m past the fused kernel
        ([40] * 30, False),  # stride 1 (> 24 patterns)
        ([512, 300], False),  # m = 512: scores up to B * m = 1024
        ([12, 40], True),  # NUL in the alphabet: the n_rows mask
    ],
)
def test_scan_corr_mxu_matches_apm(lengths, nul):
    import jax.numpy as jnp

    from apm.ops.corr_engine import _group_rows as jgroup, scan_corr_mxu as jscan
    from apm_torch.ops import corr_engine

    alphabet = b"\x00\x01\x02" if nul else b"ACGT"
    m_max = max(lengths)
    wf = 512
    halo = -(-(m_max - 1) // 128) * 128
    n_rows = 11
    corpus = _corpus((n_rows + 4) * wf + halo, 400 + m_max, alphabet)
    pats = [b"\x00" * lengths[0]] if nul else []
    pats += [bytes(_corpus(m, 410 + i, alphabet)) for i, m in enumerate(lengths[len(pats):])]
    for i, p in enumerate(pats):
        for pos in range(37 + 101 * i, len(corpus) - len(p), 1300 + 7 * i):
            corpus[pos : pos + len(p)] = np.frombuffer(p, np.uint8)
    if nul:
        corpus[(n_rows - 1) * wf :] = 0  # zeros up to and past the staged rows
    kern, thr, jkern, jthr, alph, stride, _ = _conv_tables(pats)
    start = 2 * wf
    rows = _rows_of(corpus[start:], wf, halo, n_rows + 3)  # 3 staging-padding rows
    bound = start + (n_rows - 2) * wf + 171  # mid-row
    p_out = -(-len(pats) // 8) * 8 + 8
    g_rows = corr_engine._group_rows(wf + halo, len(alph), n_rows + 3)
    assert g_rows == jgroup(wf + halo, len(alph), n_rows + 3)
    want = np.asarray(jscan(
        jnp.asarray(rows), jkern, jnp.asarray(jthr), jnp.asarray(alph),
        jnp.asarray(bound, jnp.int32), jnp.asarray(start, jnp.int32),
        wf=wf, m_max=m_max, n_rows=n_rows, g_rows=g_rows, stride=stride, p_out=p_out,
    ))
    got = corr_engine.scan_corr_mxu(
        torch.from_numpy(rows), torch.from_numpy(kern), torch.from_numpy(thr),
        torch.from_numpy(alph), bound, start, wf=wf, m_max=m_max, n_rows=n_rows,
        g_rows=g_rows, stride=stride, p_out=p_out,
    )
    assert got.dtype == torch.int32 and got.shape == (p_out,)
    assert got.tolist() == want.tolist()
    # plants may overwrite each other; the padding columns count nothing
    assert int(got.sum()) >= len(pats) and not got[len(pats):].any()


def test_scan_corr_mxu_bf16_would_merge_a_miss_at_m512():
    # the trap the port avoids: at m = 512 with B = 3 planes the threshold
    # B * m = 1536 and the nearest miss 1534 are one bf16 value
    t = torch.tensor([1536.0, 1534.0]).to(torch.bfloat16)
    assert t[0] == t[1]
    pat = bytes(_corpus(512, 430, b"ACGTN"))
    kern, thr, *_ = _conv_tables([pat])
    assert thr[0] == 3 * 512
    from apm_torch.ops import corr_engine

    wf, halo = 128, 512
    corpus = _corpus(4 * wf + halo, 431, b"ACGTN")
    corpus[10 : 10 + 512] = np.frombuffer(pat, np.uint8)
    corpus[10 + 300] = ord("N") if pat[300] != ord("N") else ord("A")  # one substitution
    corpus[140 : 140 + 512] = np.frombuffer(pat, np.uint8)
    rows = torch.from_numpy(_rows_of(corpus, wf, halo, 4))
    alph = torch.from_numpy(build_alphabet([pat]))
    got = corr_engine.scan_corr_mxu(
        rows, torch.from_numpy(kern), torch.from_numpy(thr), alph, 4 * wf, 0,
        wf=wf, m_max=512, n_rows=4, g_rows=4, stride=kern.shape[2],
    )
    assert got.tolist() == [1]


@pytest.mark.parametrize("lengths", [[50, 32], [40] * 30, [200, 100]])
def test_scan_corr_batch_matches_apm(lengths):
    import jax.numpy as jnp

    from apm.ops.corr_engine import scan_corr_batch as jscan
    from apm_torch.ops import corr_engine

    m_max = max(lengths)
    wf, fold = 256, 8
    halo = -(-(m_max - 1) // 128) * 128
    pats = [bytes(_corpus(m, 440 + i)) for i, m in enumerate(lengths)]
    corpora = [_corpus(n, 450 + i) for i, n in enumerate([3000, 700, 5000])]
    for i, p in enumerate(pats):
        c = corpora[i % 3]
        for pos in range(13 * i, len(c) - len(p), 997):
            c[pos : pos + len(p)] = np.frombuffer(p, np.uint8)
    kern, thr, jkern, jthr, alph, stride, _ = _conv_tables(pats)
    w = fold * wf
    rows = np.zeros((8 * fold, wf + halo), np.uint8)
    limits = np.zeros((8 * fold,), np.int32)
    slot = 0
    for c in corpora:
        db = len(c) - m_max + 1
        for blk in range(-(-db // w)):
            rows[slot * fold : (slot + 1) * fold] = _rows_of(c[blk * w :], wf, halo, fold)
            limits[slot * fold : (slot + 1) * fold] = np.clip(db - blk * w - np.arange(fold) * wf, 0, wf)
            slot += 1
    assert slot < 8  # padding blocks (limits 0) last
    p_out = 48
    g_rows = 24  # groups do not divide the 64 rows: apm pads the last
    want = np.asarray(jscan(
        jnp.asarray(rows), jkern, jnp.asarray(jthr), jnp.asarray(alph), jnp.asarray(limits),
        wf=wf, fold=fold, g_rows=g_rows, stride=stride, p_out=p_out,
    ))
    got = corr_engine.scan_corr_batch(
        torch.from_numpy(rows), torch.from_numpy(kern), torch.from_numpy(thr),
        torch.from_numpy(alph), torch.from_numpy(limits), wf=wf, fold=fold,
        g_rows=g_rows, stride=stride, p_out=p_out,
    )
    assert got.dtype == torch.int32 and got.shape == (8, p_out)
    assert got.tolist() == want.tolist()
    assert int(got.sum()) >= len(pats) and not got[-1].any()


# -- the prefix words of kernels B and #7 --------------------------------------


def _packed(b: bytes):
    """Little-endian word of a slot's first min(m, 8) bytes, and its mask."""
    n = min(len(b), 8)
    return int.from_bytes(b[:n], "little"), (1 << 8 * n) - 1


@pytest.mark.parametrize("m", range(1, corr_fused.M_MAX_FUSED + 1))
def test_prefix_words_of_every_pattern_length(m):
    # a NUL byte inside the pattern, a sentinel slot, and the words the
    # tables carry after the round trip through apm's ±1 layout
    rng = np.random.default_rng(600 + m)
    pat = bytearray(_corpus(m, 700 + m).tobytes())
    pat[(m - 1) // 2] = 0
    pat = bytes(pat)
    short = pat[: max(1, m // 3)]
    raw = np.zeros((3, m), np.uint8)
    raw[0] = np.frombuffer(pat, np.uint8)
    raw[2, : len(short)] = np.frombuffer(short, np.uint8)
    raw[1] = rng.integers(0, 256, m)  # bytes of a sentinel slot are ignored
    got = corr_fused.prefix_words(raw, [m, 0, len(short)])
    assert got.dtype == np.uint64 and got.shape == (3, 2)
    assert [int(x) for x in got[0]] == list(_packed(pat))
    assert [int(x) for x in got[1]] == [0, 0]
    assert [int(x) for x in got[2]] == list(_packed(short))
    pats = [pat, short]
    alph = build_alphabet(pats)
    km, thr = corr_fused.build_fused_tables(raw[[0, 2]], [m, len(short)], alph)
    tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, corr_fused.pick_s(m), "cpu")
    words = tabs.prefix.numpy().view(np.uint64)
    assert [[int(x) for x in row] for row in words] == [list(_packed(p)) for p in pats]


def test_fused_tables_from_apm_carry_prefix_words():
    # an apm.Scanner's own k = 0 tables, loaded into the port, give kernel B
    # the prefix words of the patterns they hold (1, 3 and 7 bytes too)
    from apm import ApmConfig as JaxConfig, Scanner as JaxScanner

    import apm_torch

    pats = [bytes(_corpus(m, 800 + m)) for m in (1, 3, 7, 8, 50)]
    jsc = JaxScanner(pats, 0, JaxConfig(backend="pallas", interpret=True))
    km, thr = jsc._corr_fused_tables()
    tsc = apm_torch.Scanner(pats, 0, apm_torch.ApmConfig(device="cpu"))
    arrays = {**tsc.tables(), "km": np.asarray(km, np.float32), "thr": np.asarray(thr)}
    tsc.load_tables(arrays)
    tabs = tsc._device_tables(fused_needed=True)["fused"]
    words = tabs.prefix.numpy().view(np.uint64)
    want = [_packed(p) for p in pats] + [(0, 0)] * (tabs.p - len(pats))
    assert [tuple(int(x) for x in row) for row in words] == want


@pytest.mark.parametrize(
    "make,ok",
    [
        (lambda: torch.zeros((6, 640), dtype=torch.uint8), True),
        (lambda: torch.zeros((6, 640), dtype=torch.uint8)[3:], True),  # a row offset
        (lambda: torch.zeros((6, 656), dtype=torch.uint8)[:, :640], True),  # stride 656
        (lambda: torch.zeros(6 * 640 + 16, dtype=torch.uint8)[1:6 * 640 + 1].view(6, 640), False),
        (lambda: torch.zeros((6, 648), dtype=torch.uint8)[:, :640], False),  # stride 648
        (lambda: torch.zeros((640, 6), dtype=torch.uint8).t(), False),  # column stride 6
    ],
)
def test_kernel_rows_must_be_16_byte_aligned(make, ok):
    rows = make()
    if ok:
        corr_fused.check_aligned_rows(rows)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            corr_fused.check_aligned_rows(rows)


@pytest.mark.parametrize(
    "make,ok",
    [
        (lambda: torch.zeros((6, 648), dtype=torch.uint8)[:, :640], True),  # stride 648
        (lambda: torch.zeros(6 * 640 + 16, dtype=torch.uint8)[4:6 * 640 + 4].view(6, 640), True),
        (lambda: torch.zeros(6 * 640 + 16, dtype=torch.uint8)[2:6 * 640 + 2].view(6, 640), False),
        (lambda: torch.zeros((6, 642), dtype=torch.uint8)[:, :640], False),  # stride 642
        (lambda: torch.zeros((640, 6), dtype=torch.uint8).t(), False),  # column stride 6
    ],
)
def test_filter_kernel_rows_must_be_4_byte_aligned(make, ok):
    # kernel D copies the rows into shared memory as 4-byte words
    rows = make()
    if ok:
        corr_fused.check_aligned_rows(rows, align=4)
    else:
        with pytest.raises(ValueError, match="4-byte"):
            corr_fused.check_aligned_rows(rows, align=4)
