"""NumPy models of the count kernels' tile walk (kernels A and C, their batch
mode #4 and A's dynamic-length entry #9: ``csrc/dp_band.cu`` and
``csrc/dp_myers.cu`` on ``csrc/dp_pair.cuh``), held against the plain
versions and against apm (Pallas in interpret mode).

The CUDA kernels run only on the card; this file argues their control flow
and arithmetic where no card is present. The verdict pairs come from the
step models the mask kernels' tests use (``tests/pair_models.py``: the
paired 16-bit DPX band, the packed and two-chain Myers bands, on text
staged once a tile); :func:`walk_model` repeats what the count kernels do
with them:

* ``grid`` blocks walk the ``R * n_tiles`` tiles of 512 windows
  grid-stride (tiles never cross a row; a row whose wf is not a multiple
  of 512 ends in a partial tile);
* a tile whose first lane is not owned is skipped, by the whole block;
* ownership is decided for each window of a thread's pair, so an odd
  limit leaves the pair's second window unowned;
* each thread adds its owned hits of a pattern, 0, 1 or 2, to the block's
  counter, and a length outside ``[1, m_max]`` scans nothing;
* count mode adds every block's counters to the ``(P,)`` output at the
  end; batch mode adds them to the tile's slot ``r // 8`` after every tile.

Counts are integers: the tolerance is 0. The card holds the kernels
themselves to the same plain versions (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 2, 2b, 2c and 2e).
"""

import numpy as np
import pytest
import torch

from apm_torch.ops import dp_kernel
from apm_torch.ops.common import fold_corpus, round_up
from apm_torch.utils.io import PatternSet
from pair_models import K_WIN, band_verdicts, myers_verdicts

WF = 128
FOLD = 8
ALPH = tuple(b"ACGT")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def walk_model(pairs, plens, m_max, limits, *, grid=3, batch=False):
    """``(counts, hist)`` of the count kernels' tile walk over per-pattern
    verdict pairs ``(P, R, n_tiles, 256, 2)``: ``limits[r]`` lanes of row
    ``r`` are owned; counts are ``(P,)``, or ``(R / 8, P)`` in batch mode;
    ``hist[h]`` is how often a thread added ``h`` hits."""
    n_pat, n_rows, n_tiles = pairs.shape[:3]
    lanes = np.arange(K_WIN).reshape(K_WIN // 2, 2)  # thread t: lanes 2t, 2t + 1
    out = np.zeros((n_rows // FOLD, n_pat) if batch else (n_pat,), np.int64)
    hist = np.zeros(3, np.int64)
    for b in range(grid):
        cnt = np.zeros(n_pat, np.int64)  # the block's shared counters
        for t in range(b, n_rows * n_tiles, grid):
            r, i = divmod(t, n_tiles)
            lane0 = i * K_WIN
            if lane0 >= limits[r]:
                continue  # the whole block skips the tile
            own = lane0 + lanes < limits[r]  # (256, 2): each window of a pair
            for p, m in enumerate(plens):
                if not 0 < m <= m_max:
                    continue
                per = (pairs[p, r, i] & own).sum(axis=1)  # 0, 1 or 2 a thread
                hist += np.bincount(per, minlength=3)
                cnt[p] += per.sum()
            if batch:  # flush into the tile's row-block slot
                out[r // FOLD] += cnt
                cnt[:] = 0
        if not batch:
            out += cnt
    return out.astype(np.int32), hist


def _owned(n_rows, wf, bound, start):
    return np.clip(bound - start - np.arange(n_rows) * wf, 0, wf)


def _batch_owned(meta, wf):
    m = np.repeat(meta.astype(np.int64), FOLD, axis=0)
    sub = np.arange(m.shape[0]) % FOLD
    return np.clip(m[:, 0] - m[:, 1] - sub * wf, 0, wf)


def _case(text, k, lengths, *, n_rows=8, wf=WF, start=WF + 37, seed=0):
    """Staged rows from ``start`` (any byte offset), the k-padded table (8
    slots), lengths, m_max and halo of one case; random ACGT patterns
    planted into the text with up to min(k, 2) edits."""
    from apm_torch.utils.corpus import plant

    rng = np.random.default_rng(seed)
    n = start + (n_rows + 1) * wf + max(lengths) + 256
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if text == "all-A":
        corpus = np.full(n, ord("A"), np.uint8)
        pats = [b"A" * m for m in lengths]
    else:
        letters = acgt if text == "random" else np.frombuffer(b"ACGT\x00N\xff", np.uint8)
        corpus = letters[rng.integers(0, len(letters), n)]
        pats = [acgt[rng.integers(0, 4, m)].tobytes() for m in lengths]
        step = max(331, 2 * max(lengths) + 17)
        for i, p in enumerate(pats):
            plant(corpus, np.frombuffer(p, np.uint8), range(start + 40 + 97 * i, n - max(lengths) - 64, step),
                  k=min(k, 2), seed=seed + i)
    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    pat = np.zeros((8, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    plens = tuple(lengths) + (0,) * (8 - len(pats))
    halo = round_up(ps.max_len + 2 * k, 128)
    rows = fold_corpus(corpus, start, n_rows, wf, halo)
    return rows, pat, plens, ps.max_len, halo


def _verdicts(rows, pat, plens, m_max, k, wf, impl):
    if impl == "myers":
        return myers_verdicts(rows, pat, k=k, m_max=m_max, wf=wf, plens=plens, alphabet=ALPH)
    return band_verdicts(rows, pat, k=k, m_max=m_max, wf=wf, plens=plens)


def _count_three_way(rows, pat, plens, m_max, halo, k, impl, *, wf=WF, start=WF + 37,
                     row_off=5, in_row=77):
    """Model, plain count and apm's ``_scan_folded_pallas_unrolled`` on a
    bound ``in_row`` windows into row ``row_off`` (odd: a pair straddles
    it); the model under three grids."""
    import jax.numpy as jnp

    from apm.ops.pallas_kernel import _scan_folded_pallas_unrolled

    bound = start + row_off * wf + in_row
    limits = _owned(rows.shape[0], wf, bound, start)
    pairs = _verdicts(rows, pat, plens, m_max, k, wf, impl)
    got, hist = walk_model(pairs, plens, m_max, limits)
    for grid in (1, 5):
        assert walk_model(pairs, plens, m_max, limits, grid=grid)[0].tolist() == got.tolist()
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
    r, p = torch.from_numpy(rows), torch.from_numpy(pat)
    if impl == "myers":
        assert dp_kernel._is_myers(k, m_max, plens, ALPH, "myers")
        ref = dp_kernel.scan_folded_myers_ref(r, p, bound, start, alphabet=ALPH, **kw)
    else:
        ref = dp_kernel.scan_folded_dp_ref(r, p, bound, start, **kw)
    want = _scan_folded_pallas_unrolled(
        jnp.asarray(rows), jnp.asarray(pat), jnp.asarray(bound, jnp.int32),
        jnp.asarray(start, jnp.int32), interpret=True,
        alphabet=ALPH if impl == "myers" else (), dp_impl=impl, **kw)
    assert got.tolist() == ref.tolist() == np.asarray(want).tolist()
    assert hist.sum() > 0
    return got, hist


@pytest.mark.parametrize(
    "k,impl,lengths",
    [(0, "band", [24, 40]), (1, "band", [24, 40]), (3, "band", [24, 40]),
     (7, "band", [24, 40]), (8, "band", [24, 40]), (12, "band", [24, 40]),
     (16, "band", [20, 18]), (17, "band", [20, 18]),  # the widest band in registers, then scratch
     (1, "myers", [24, 40]), (3, "myers", [24, 40]), (7, "myers", [24, 40]),  # packed pairs
     (8, "myers", [24, 40]), (12, "myers", [24, 40])],  # two chains a thread
)
def test_count_walk_matches_plain_and_apm(k, impl, lengths):
    rows, pat, plens, m_max, halo = _case("random", k, lengths, seed=20 + k)
    counts, _ = _count_three_way(rows, pat, plens, m_max, halo, k, impl)
    assert counts.sum() > 0


@pytest.mark.parametrize(
    "case,k,impl",
    [("partial-tile", 1, "band"), ("partial-tile", 3, "myers"),  # wf = 640: 512 + 128
     ("odd-wf", 1, "band"), ("odd-wf", 3, "myers"),  # wf = 127: a row's last pair half past it
     ("all-A", 1, "band"), ("all-A", 3, "myers"),  # 0, 1 and 2 hits a thread
     ("foreign", 1, "band"), ("foreign", 2, "myers"),  # NUL and bytes outside the alphabet
     ("m<=k", 2, "band"), ("m<=k", 3, "myers")],  # m < k, m = k, m = m_max
)
def test_count_walk_edges(case, k, impl):
    wf = {"partial-tile": 640, "odd-wf": 127}.get(case, WF)
    lengths = {"all-A": [40, 12, k + 1], "m<=k": [max(k - 1, 1), k, 30]}.get(case, [24, 40])
    text = case if case in ("all-A", "foreign") else "random"
    # partial tiles: the bound inside the second (partial) tile of row 5
    in_row = 555 if case == "partial-tile" else 77 if wf > 77 else 51
    start = wf + 37
    rows, pat, plens, m_max, halo = _case(text, k, lengths, wf=wf, start=start, seed=40 + k)
    counts, hist = _count_three_way(rows, pat, plens, m_max, halo, k, impl, wf=wf, start=start,
                                    in_row=in_row)
    assert counts.sum() > 0
    if case == "all-A":  # every owned window of every pattern; the bound's pair adds 1
        assert counts[:3].tolist() == [5 * wf + in_row] * 3
        assert hist[0] > 0 and hist[1] == 3 and hist[2] > 0


def test_count_walk_table_past_32k():
    # an 8200-byte pattern: 4 * (8200 + 2) bytes of table pass 32 KB, so the
    # kernel reads text and pattern from global memory on the same steps
    k = 1
    rows, pat, plens, m_max, halo = _case("random", k, [8200, 10, 24], seed=70)
    assert 4 * pat.shape[1] > 32 << 10 and dp_kernel._table_group(pat.shape[1]) == 8192
    counts, _ = _count_three_way(rows, pat, plens, m_max, halo, k, "band")
    assert counts[1:3].sum() > 0


@pytest.mark.parametrize("k,impl", [(1, "band"), (3, "band"), (3, "myers"), (12, "myers")])
def test_batch_walk_matches_plain_and_apm(k, impl):
    # kernel #4: one [bound, start] pair a block of 8 rows, limits of 0,
    # odd and whole rows; the counts go to the tile's slot r // 8
    import jax.numpy as jnp

    from apm.ops.pallas_kernel import _scan_folded_pallas_batch

    rows, pat, plens, m_max, halo = _case("random", k, [24, 40], n_rows=32, seed=80 + k)
    w = FOLD * WF
    meta = np.array([[0, 0], [w + 3 * WF + 77, w], [2 * w + w, 2 * w], [3 * w + 5 * WF + 1, 3 * w]],
                    np.int32)
    limits = _batch_owned(meta, WF)
    pairs = _verdicts(rows, pat, plens, m_max, k, WF, impl)
    got, _ = walk_model(pairs, plens, m_max, limits, batch=True)
    assert walk_model(pairs, plens, m_max, limits, grid=7, batch=True)[0].tolist() == got.tolist()
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens, alphabet=ALPH, dp_impl=impl)
    ref = dp_kernel.scan_folded_dp_batch_ref(torch.from_numpy(rows), torch.from_numpy(pat),
                                             torch.from_numpy(meta), **kw)
    want = _scan_folded_pallas_batch(
        jnp.asarray(rows), jnp.asarray(pat), jnp.asarray(meta), interpret=True,
        **dict(kw, alphabet=ALPH if impl == "myers" else ()))
    assert got.tolist() == ref.tolist() == np.asarray(want).tolist()
    assert got[0].sum() == 0 and got[1:].sum() > 0


@pytest.mark.parametrize("k", [0, 1, 3])
def test_dyn_walk_matches_plain_and_apm(k):
    # kernel #9: the lengths read from device memory; 0, m_max + 1 and -1
    # count nothing, the others their windows
    import jax.numpy as jnp

    from apm.ops.pallas_kernel import scan_folded_pallas

    rows, pat, plens, m_max, halo = _case("random", k, [24, 40, 12, 30], n_rows=16, seed=90 + k)
    start = WF + 37
    bound = start + 13 * WF + 77
    limits = _owned(rows.shape[0], WF, bound, start)
    for lens in ((24, 40, 12, 30, 0, 0, 0, 0), (0, m_max + 1, 12, -1, 20, 0, 0, 0)):
        pairs = _verdicts(rows, pat, lens, m_max, k, WF, "band")
        got, _ = walk_model(pairs, lens, m_max, limits)
        live = [m if 0 < m <= m_max else 0 for m in lens]
        ref = dp_kernel.scan_folded_ref(
            torch.from_numpy(rows), torch.from_numpy(pat), torch.tensor(live, dtype=torch.int32),
            bound, start, k=k, m_max=m_max, wf=WF, halo=halo)
        want = scan_folded_pallas(
            jnp.asarray(rows), jnp.asarray(pat), jnp.asarray(lens, jnp.int32),
            jnp.asarray(bound, jnp.int32), jnp.asarray(start, jnp.int32),
            k=k, m_max=m_max, wf=WF, halo=halo, interpret=True)
        assert got.tolist() == ref.tolist() == np.asarray(want).tolist()
        assert got.sum() > 0 and not got[[m == 0 for m in live]].any()
