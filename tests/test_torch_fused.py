"""Filtration phase 2 and conv phase 1 of the port against apm's.

On the same staged rows and tables, the port's ``scan_pieces_conv`` must
give apm's ``(fcnt, rowmap)``, and ``filter_verify_chunk`` (with kernel D's
phase 1 and with the piece conv's, against apm's ``filter_verify_chunk``
and ``filter_verify_chunk_conv``) and ``count_hot_batch`` (plain versions,
as the CPU runs them) must give apm's packed vectors and counts, field by field
through ``unpack_chunk`` — apm's Pallas kernels in interpret mode. Every
output is an integer: tolerance 0.
"""

from functools import partial

import numpy as np
import pytest
import torch

from apm_torch.ops import corr_engine, filter_kernel, fused
from apm_torch.ops.common import fold_corpus, round_up
from apm_torch.utils.corpus import plant
from apm_torch.utils.io import PatternSet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WF = 256
N_ROWS = 32


def _setup(lengths, k, seed, every=900):
    """32 staged rows with a planted copy of each pattern about every
    ``every`` bytes, the raw and k-padded tables padded to 8 slots, static
    lengths and the alphabet."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(b"ACGT", np.uint8)
    corpus = np.frombuffer(b"ACGT\n", np.uint8)[rng.integers(0, 5, N_ROWS * WF + 512)]
    pats = []
    for i, m in enumerate(lengths):
        p = a[rng.integers(0, 4, m)]
        plant(corpus, p, range(29 + 61 * i, len(corpus) - 300, every), k=min(k, 3),
              seed=seed + i)
        pats.append(p.tobytes())
    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    pat = np.zeros((8, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    raw = np.zeros((8, ps.max_len), np.uint8)
    raw[: len(pats)] = ps.table
    plens = tuple(lengths) + (0,) * (8 - len(lengths))
    halo = round_up(ps.max_len + 2 * k, 128)
    rows = fold_corpus(corpus, 0, N_ROWS, WF, halo)
    alph = corr_engine.build_alphabet(pats)
    return rows, raw, pat, plens, ps.max_len, halo, alph


def _j(x, dtype=None):
    import jax.numpy as jnp

    return jnp.asarray(x, dtype) if dtype is not None else jnp.asarray(x)


def _same_packed(got, want, p):
    g, w = fused.unpack_chunk(got.numpy(), p), fused.unpack_chunk(np.asarray(want), p)
    for name, a, b in zip(("fcnt", "vcnt", "n_hot", "clip_starts"), g, w):
        assert np.array_equal(a, b), (name, a, b)
    return g


def _piece_tables(raw, plens, k, alph, stride):
    from apm.ops.corr_engine import build_piece_kernel

    kern, thr, owner = corr_engine.build_piece_kernel(raw, plens, k, alph, stride=stride)
    jkern, jthr, jowner = build_piece_kernel(raw, plens, k, alph, stride=stride)
    return (kern, thr, owner), (jkern, jthr, jowner)


@pytest.mark.parametrize("k,lengths,stride", [(1, [32, 50], 1), (2, [32, 50], 16), (4, [50, 50, 50], 0)])
def test_scan_pieces_conv_matches_apm(k, lengths, stride):
    from apm.ops.corr_engine import scan_pieces_conv

    rows, raw, pat, plens, m_max, halo, alph = _setup(lengths, k, seed=70 + k)
    if stride == 0:
        stride = corr_engine.pick_stride(len(lengths) * (k + 1))
    assert stride > 1 or k == 1
    (kern, thr, owner), (jkern, jthr, jowner) = _piece_tables(raw, plens, k, alph, stride)
    n_rows, g_rows = N_ROWS - 3, 8  # staged padding rows; four groups
    bound = 20 * WF + 77
    kw = dict(wf=WF, w_kern=kern.shape[0], n_rows=n_rows, g_rows=g_rows, stride=stride)
    jf, jr = scan_pieces_conv(_j(rows), jkern, _j(jthr), _j(jowner), _j(alph),
                              _j(bound, np.int32), _j(0, np.int32), **kw)
    tf, tr = corr_engine.scan_pieces_conv(
        torch.from_numpy(rows), torch.from_numpy(kern), torch.from_numpy(thr),
        torch.from_numpy(owner), torch.from_numpy(alph), bound, 0, **kw)
    assert tf.dtype == tr.dtype == torch.int32
    assert tf.tolist() == np.asarray(jf).tolist()
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert tr.sum() > 0 and not tr[21:].any()


@pytest.mark.parametrize("k,lengths", [(1, [32, 50]), (3, [32, 50]), (8, [120, 120])])
def test_filter_verify_chunk_matches_apm(k, lengths):
    # kernel D's phase 1, then phase 2 with kernel A (k = 1) or C (k >= 3);
    # more hot rows than the bucket and a clipped row at the bound
    from apm.ops.fused import filter_verify_chunk

    rows, raw, pat, plens, m_max, halo, alph = _setup(lengths, k, seed=80 + k, every=500)
    bound = (N_ROWS - 2) * WF + 130
    rows[N_ROWS - 2, 50 : 50 + lengths[1]] = raw[1, : lengths[1]]  # in the clipped row
    max_hot = 8
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens, max_hot=max_hot,
              alphabet=tuple(int(b) for b in alph), dp_impl="auto")
    jp, jr = filter_verify_chunk(_j(rows), _j(raw), _j(pat), _j(bound, np.int32),
                                 _j(0, np.int32), interpret=True, **kw)
    phase1 = partial(filter_kernel.scan_filter, pat_raw=torch.from_numpy(raw), k=k,
                     m_max=m_max, wf=WF, halo=halo, plens=plens, plain=True)
    tp, tr = fused.filter_verify_chunk(
        torch.from_numpy(rows), phase1, torch.from_numpy(pat), bound, 0, plain=True, **kw)
    fcnt, vcnt, n_hot, clips = _same_packed(tp, jp, 8)
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert n_hot > max_hot and vcnt.sum() > 0 and (clips >= 0).sum() == 1


@pytest.mark.parametrize("k", [2, 4])
def test_filter_verify_chunk_conv_matches_apm(k):
    from apm.ops.fused import filter_verify_chunk_conv

    lengths = [32, 50] if k == 2 else [50, 50, 50]
    rows, raw, pat, plens, m_max, halo, alph = _setup(lengths, k, seed=90 + k, every=700)
    stride = corr_engine.pick_stride(len(lengths) * (k + 1))
    (kern, thr, owner), (jkern, jthr, jowner) = _piece_tables(raw, plens, k, alph, stride)
    bound = (N_ROWS - 1) * WF + 3
    conv = dict(w_kern=kern.shape[0], n_rows=N_ROWS, g_rows=16)
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens, max_hot=16,
              alphabet=tuple(int(b) for b in alph), dp_impl="auto")
    jp, jr = filter_verify_chunk_conv(
        _j(rows), jkern, _j(jthr), _j(jowner), _j(alph), _j(pat),
        _j(bound, np.int32), _j(0, np.int32), interpret=True, fp1_stride=stride, **conv, **kw)
    phase1 = partial(corr_engine.scan_pieces_conv, kern=torch.from_numpy(kern),
                     thr=torch.from_numpy(thr), owner=torch.from_numpy(owner),
                     alph=torch.from_numpy(alph), wf=WF, stride=stride, **conv)
    tp, tr = fused.filter_verify_chunk(
        torch.from_numpy(rows), phase1, torch.from_numpy(pat), bound, 0, plain=True, **kw)
    _, vcnt, n_hot, _ = _same_packed(tp, jp, 8)
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert n_hot > 0 and vcnt.sum() > 0


@pytest.mark.parametrize("k", [1, 3])
def test_count_hot_batch_matches_apm(k):
    from apm.ops.filter_kernel import scan_filter_pallas
    from apm.ops.fused import count_hot_batch

    rows, raw, pat, plens, m_max, halo, alph = _setup([32, 50], k, seed=100 + k, every=400)
    bound = (N_ROWS - 1) * WF + 40
    _, jrowmap = scan_filter_pallas(_j(rows), _j(raw), _j(bound, np.int32), _j(0, np.int32),
                                    k=k, m_max=m_max, wf=WF, halo=halo, plens=plens,
                                    interpret=True)
    rowmap = torch.from_numpy(np.array(jrowmap))
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens, n_batch=8, cap=24,
              alphabet=tuple(int(b) for b in alph), dp_impl="auto")
    total = np.zeros(8, np.int64)
    for b in range(3):
        want = count_hot_batch(_j(rows), jrowmap, _j(pat), _j(bound, np.int32),
                               _j(0, np.int32), _j(b, np.int32), interpret=True, **kw)
        got = fused.count_hot_batch(torch.from_numpy(rows), rowmap, torch.from_numpy(pat),
                                    bound, 0, b, plain=True, **kw)
        assert got.tolist() == np.asarray(want).tolist(), b
        total += got.numpy()
    assert (rowmap.sum(1) > 0).sum() > 8 and total.sum() > 0


def test_compact_is_a_fixed_size_nonzero():
    rng = np.random.default_rng(3)
    for n, size in ((50, 8), (50, 64), (1, 1), (300, 100)):
        mask = rng.random(n) < 0.3
        want = np.nonzero(mask)[0][:size]
        got = fused._compact(torch.from_numpy(mask), size, n).numpy()
        assert got.shape == (size,)
        assert got[: len(want)].tolist() == want.tolist()
        assert (got[len(want):] == n).all()
