"""Kernel D's plain version against apm's shift-OR filtration kernel.

``scan_filter_ref`` (and the ``scan_filter`` wrapper, which takes it for CPU
tensors) must give exactly the ``(fcnt, rowmap)`` of
``apm.ops.filter_kernel.scan_filter_pallas(..., interpret=True)`` on the same
staged rows: candidate totals and per-row candidate counts, cell for cell.
Both are integers: tolerance 0. The CUDA kernel itself is compared with the
same plain version on the card (``chip_smoke.py`` phase 3b,
``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from apm_torch.ops import filter_kernel
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


def _setup(lengths, k, n_rows, seed, start_row=0, alphabet=b"ACGT", n_pad=8):
    """Staged rows of a corpus with planted (k-substituted) copies of each
    pattern, the raw pattern table padded to n_pad slots, and the static
    lengths (0 for slots filtration does not take)."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    corpus = a[rng.integers(0, len(a), (start_row + n_rows) * WF + 512)]
    pats = []
    for i, m in enumerate(lengths):
        p = a[rng.integers(0, len(a), m)]
        plant(corpus, p, range(37 + 53 * i, len(corpus) - 300, 331), k=min(k, 3),
              seed=seed + i)
        pats.append(p.tobytes())
    ps = PatternSet.from_patterns(pats)
    raw = np.zeros((n_pad, ps.max_len), np.uint8)
    raw[: len(pats)] = ps.table
    plens = tuple(m if filter_kernel.filter_eligible(m, k) else 0 for m in lengths)
    plens += (0,) * (n_pad - len(lengths))
    halo = round_up(ps.max_len + 2 * k, 128)
    rows = fold_corpus(corpus, start_row * WF, n_rows, WF, halo)
    return rows, raw, plens, ps.max_len, halo


def _apm(rows, raw, bound, start, k, m_max, halo, plens):
    import jax.numpy as jnp

    from apm.ops.filter_kernel import scan_filter_pallas

    fcnt, rowmap = scan_filter_pallas(
        jnp.asarray(rows), jnp.asarray(raw),
        jnp.asarray(bound, jnp.int32), jnp.asarray(start, jnp.int32),
        k=k, m_max=m_max, wf=WF, halo=halo, plens=plens, interpret=True,
    )
    return np.asarray(fcnt), np.asarray(rowmap)


def _port(rows, raw, bound, start, k, m_max, halo, plens):
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens)
    r, p = torch.from_numpy(rows), torch.from_numpy(raw)
    before = filter_kernel.LAUNCHES
    fcnt, rowmap = filter_kernel.scan_filter_ref(r, p, bound, start, **kw)
    wf, wr = filter_kernel.scan_filter(r, p, bound, start, **kw)
    assert filter_kernel.LAUNCHES == before  # CPU tensors never launch
    assert fcnt.dtype == rowmap.dtype == torch.int32
    assert fcnt.shape == (raw.shape[0],) and rowmap.shape == (rows.shape[0], raw.shape[0])
    assert torch.equal(fcnt, wf) and torch.equal(rowmap, wr)
    return fcnt.numpy(), rowmap.numpy()


def _check(rows, raw, bound, start, k, m_max, halo, plens):
    want = _apm(rows, raw, bound, start, k, m_max, halo, plens)
    got = _port(rows, raw, bound, start, k, m_max, halo, plens)
    assert got[0].tolist() == want[0].tolist()
    assert np.array_equal(got[1], want[1])
    return got


@pytest.mark.parametrize(
    "k,lengths,tiers",
    [
        (0, [12, 20], {(1, 0)}),  # k = 0: candidates are exact matches
        (1, [32, 50], {(2, 0)}),
        (3, [32, 50], {(4, 0)}),
        (5, [84, 50, 40], {(6, 0), (3, 1)}),  # both tiers and an ineligible slot
        (8, [120, 120], {(5, 1)}),
        (16, [160, 170], {(9, 1)}),
    ],
)
def test_filter_ref_matches_apm(k, lengths, tiers):
    n_rows = 16
    rows, raw, plens, m_max, halo = _setup(lengths, k, n_rows, seed=10 + k)
    assert {filter_kernel.tier_of(m, k) for m in plens if m} == tiers
    bound = n_rows * WF - m_max + 1
    fcnt, rowmap = _check(rows, raw, bound, 0, k, m_max, halo, plens)
    assert fcnt[: len(lengths)].sum() > 0
    assert (rowmap.sum(axis=0) == fcnt).all()
    if k == 0:  # candidates are the exact matches of each owned window
        for p, m in enumerate(lengths):
            wins = np.lib.stride_tricks.sliding_window_view(rows, m, axis=1)[:, :WF]
            hit = (wins == raw[p, :m]).all(axis=2).reshape(-1)[:bound]
            assert fcnt[p] == hit.sum()


def test_filter_ref_start_and_mid_row_bound():
    k, n_rows, start_row = 3, 16, 5
    rows, raw, plens, m_max, halo = _setup([32, 50, 9], k, n_rows, seed=40,
                                           start_row=start_row)
    assert plens[2] == 0  # m = 9 at k = 3 is not filtration-eligible
    start = start_row * WF
    bound = start + 9 * WF + 101  # row 9 owns 101 windows, rows past it none
    fcnt, rowmap = _check(rows, raw, bound, start, k, m_max, halo, plens)
    assert not rowmap[10:].any() and rowmap[:9].any()


@pytest.mark.parametrize("k", [1, 5])
def test_filter_ref_full_byte_range(k):
    # text and patterns over all 256 byte values: the 256 sentinel of the
    # padded table must never equal a text byte (0xFF included)
    alphabet = bytes(range(256))
    lengths = [40, 90] if k == 1 else [84, 60]
    rows, raw, plens, m_max, halo = _setup(lengths, k, 8, seed=50 + k,
                                           alphabet=alphabet)
    assert all(plens[: len(lengths)])
    rows[2, 10:20] = 0xFF
    bound = 8 * WF - m_max + 1
    fcnt, _ = _check(rows, raw, bound, 0, k, m_max, halo, plens)
    assert fcnt[: len(lengths)].sum() > 0


def test_filter_wrapper_checks_its_inputs():
    k = 1
    rows, raw, plens, m_max, halo = _setup([32], k, 8, seed=60)
    r, p = torch.from_numpy(rows), torch.from_numpy(raw)
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens)
    with pytest.raises(ValueError):
        filter_kernel.scan_filter(r.to(torch.int32), p, 100, 0, **kw)
    with pytest.raises(ValueError):  # halo below m_max + 2k
        filter_kernel.scan_filter(r[:, :-100], p, 100, 0, **{**kw, "halo": halo - 100})
    with pytest.raises(ValueError):  # a length filtration does not take
        filter_kernel.scan_filter(r, p, 100, 0, **{**kw, "plens": (9,) + plens[1:]})
    with pytest.raises(ValueError):
        filter_kernel.scan_filter(r, p[:, 1:], 100, 0, **kw)


def test_piece_plan_lists_every_piece_with_its_shifts():
    plens = (84, 50, 0, 0)
    k = 5
    pieces, pstart, span = filter_kernel.piece_plan(plens, k)
    assert pstart.tolist() == [0, 6, 9, 9, 9]  # 6 exact pieces, 3 banded, two padding slots
    rows = []
    for m in (84, 50):
        j, kp = filter_kernel.tier_of(m, k)
        for idx, (o, li) in enumerate(filter_kernel.pieces_of_j(m, j)):
            rows.append((o, li, kp) + filter_kernel.piece_shift_range(idx, j, o, li, m, k, kp))
    assert [tuple(r) for r in pieces.tolist()] == rows
    assert span == max(r[4] - r[3] for r in rows)
    assert filter_kernel.sentinel_pad(plens, k) == 1
    table = filter_kernel.pchar_table(torch.zeros((4, 84), dtype=torch.uint8), 1)
    assert table.shape == (4, 87) and int(table[0, 0]) == filter_kernel.SENTINEL
