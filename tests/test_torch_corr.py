"""Kernel B's plain version against apm's fused Pallas correlation kernel.

``scan_corr_fused_ref`` (and the ``scan_corr_fused`` wrapper, which takes
it for CPU tensors) must give exactly the counts of
``apm.ops.corr_fused.scan_corr_fused(..., interpret=True)`` on the same
staged rows and tables, on the cases of ``tests/test_corr_fused.py``.
Counts are integers: tolerance 0. The CUDA kernel is compared with the same
plain version on the card (``chip_smoke.py`` phase 3).
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
