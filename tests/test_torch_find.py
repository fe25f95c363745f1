"""The port's Scanner.find and its position helpers, held against apm
(Pallas in interpret mode) and the oracle.

Kernel level: the plain mask mode of the banded DP (TPU kernel #6, band and
Myers) against ``apm.ops.pallas_kernel.scan_folded_pallas_mask``, counts
and verdicts cell for cell; the per-row top-k positions, the bit pack and
its inverse against ``apm.ops.fused``'s. Entry level: ``find`` three ways
(port, apm, oracle positions) on the filtration path, the dense sweep,
mixed eligibility, with ``limit`` and an EOF tail, and on each device
branch — per-row positions, the packed-mask fallback, the ``gpos`` decode
and the gather batches — forced by shrinking ``POS_CAP`` and
``FIND_BATCH`` in BOTH packages. Positions are integers: the tolerance
is 0.
"""

import numpy as np
import pytest
import torch

import apm
import apm.ops.fused as jfused
from apm import ApmConfig as JaxConfig
from apm.utils.oracle import banded_distances

import apm_torch
from apm_torch import ApmConfig
from apm_torch.ops import dp_kernel
from apm_torch.ops import fused as tfused
from apm_torch.ops.common import fold_corpus, round_up
from apm_torch.utils.corpus import plant


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


def _oracle_positions(corpus, pat, k):
    return np.nonzero(banded_distances(corpus, pat, k) <= k)[0].tolist()


def _three_way_find(pats, k, corpus, limit=None, **cfg):
    """find() of both packages and the oracle; returns the port's Scanner."""
    cfg.setdefault("block_windows", 1024)
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", **cfg))
    jsc = apm.Scanner(pats, k, JaxConfig(backend="pallas", interpret=True, **cfg))
    got = tsc.find(corpus, limit=limit)
    want = jsc.find(corpus, limit=limit)
    assert len(got) == len(pats)
    counts = tsc.count(corpus)
    for pi, pat in enumerate(pats):
        assert got[pi].dtype == np.int64
        assert got[pi].tolist() == want[pi].tolist(), ("apm", pi)
        oracle = _oracle_positions(corpus, pat, k)
        assert got[pi].tolist() == oracle[:limit], ("oracle", pi)
        if limit is None:
            assert len(got[pi]) == counts[pi]
    return tsc


def _table(pats, k):
    from apm_torch.utils.io import PatternSet

    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    pat = np.zeros((8, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    plens = tuple(len(p) for p in pats) + (0,) * (8 - len(pats))
    return pat, plens, ps.max_len


@pytest.mark.parametrize("k,dp_impl", [(0, "band"), (1, "band"), (2, "myers"), (3, "auto")])
def test_mask_dp_plain_matches_pallas(k, dp_impl):
    from apm.ops.pallas_kernel import scan_folded_pallas_mask

    c = _corpus(24 * 128 + 512, 900 + k)
    pats = [bytes(c[100:130]), bytes(c[1000:1012]), b"ACGTTGCAAC"]
    pat, plens, m_max = _table(pats, k)
    wf, halo = 128, round_up(m_max + 2 * k, 128)
    rows = fold_corpus(c, 2 * wf, 24, wf, halo)
    bound = 2 * wf + 21 * wf + 77  # mid-row
    alph = tuple(sorted(set(b"".join(pats))))
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=alph, dp_impl=dp_impl)
    counts, mask = dp_kernel.scan_folded_dp_mask(
        torch.from_numpy(rows), torch.from_numpy(pat), bound, 2 * wf, **kw
    )
    jc, jm = scan_folded_pallas_mask(
        rows, pat, np.int32(bound), np.int32(2 * wf), interpret=True, **kw
    )
    assert mask.dtype == torch.uint8 and tuple(mask.shape) == (24, 8, wf)
    assert counts.tolist() == np.asarray(jc).tolist()
    assert np.array_equal(mask.numpy(), np.asarray(jm).astype(np.uint8))
    assert int(counts.sum()) > 0 and int(mask[22:].sum()) < int(mask[:22].sum())
    # the count mode gives the same counts
    assert dp_kernel.scan_folded_dp(
        torch.from_numpy(rows), torch.from_numpy(pat), bound, 2 * wf, **kw
    ).tolist() == counts.tolist()


@pytest.mark.parametrize("c", [4, 32, 5000])
def test_row_topk_and_bits_match_apm(c):
    rng = np.random.default_rng(c)
    mask = (rng.random((16, 8, 256)) < 0.02).astype(np.int8)
    mask[3] = 1  # a row past any cap
    mask[5] = 0
    mask[:, 6:] = 0  # padding patterns
    p_real = 6
    pos, cnt = tfused._row_topk_positions(torch.from_numpy(mask.astype(np.uint8)), p_real, 256, c)
    jpos, jcnt = jfused._row_topk_positions(mask, p_real, 256, c)
    assert pos.dtype == torch.int32 and cnt.dtype == torch.int32
    assert pos.numpy().tolist() == np.asarray(jpos).tolist()
    assert cnt.numpy().tolist() == np.asarray(jcnt).tolist()
    bits = tfused._pack_mask_bits(torch.from_numpy(mask.astype(np.uint8)), p_real).numpy()
    jbits = np.asarray(jfused._pack_mask_bits(mask, p_real))
    assert np.array_equal(bits.view("<u4"), jbits)
    for pi in range(p_real):
        want = jfused.unpack_mask_bits(jbits, pi, 16)
        assert np.array_equal(tfused.unpack_mask_bits(bits, pi, 16), want)
        assert np.array_equal(tfused.unpack_mask_bits(jbits, pi, 16), want)
        assert np.array_equal(want, mask[:, pi].astype(np.uint8))


def _plant_fuzzy(corpus, pat, k, positions, seed):
    plant(corpus, np.frombuffer(bytes(pat), np.uint8), positions, k=k, seed=seed)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_find_filter_and_dense_paths(k):
    # a 50-mer takes the filtration path, a 6-mer (ineligible at k >= 1) the
    # dense sweep; the duplicate shares its positions
    c = _corpus(3000, 910 + k)
    long_pat, short_pat = bytes(_corpus(50, 911, b"ACGT")), bytes(_corpus(6, 912, b"ACGT"))
    _plant_fuzzy(c, long_pat, k, [111, 1502, 2750], 913)
    tsc = _three_way_find([long_pat, short_pat, long_pat], k, c, strategy="single")
    if k:
        assert set(tsc.last_find) == {"filter", "dense"}


def test_find_limit_and_tail():
    c = _corpus(400, 920)
    pat = bytes(_corpus(50, 921, b"ACGT"))
    c[390:400] = np.frombuffer(pat[:10], np.uint8)  # EOF-truncated windows
    for limit in (None, 2):
        _three_way_find([pat], 3, c, limit=limit)


def test_find_all_windows_match_filter_path():
    c = np.full(6000, ord("A"), dtype=np.uint8)
    pat = bytes(b"A" * 49 + b"C")  # k = 1 still matches every window
    tsc = _three_way_find([pat], 1, c)
    assert tsc.last_find["filter"]["bits"] > 0  # every row past POS_CAP


def test_find_dense_sweep_overflow_multichunk():
    # all-ineligible set on all-A text: the sweep resolves every position,
    # past FIND_BATCH hot rows, over several chunks
    c = np.full(30000, ord("A"), dtype=np.uint8)
    pat = bytes(b"AAACAAAA")
    tsc = _three_way_find([pat], 2, c, chunk_bytes=8192)
    assert set(tsc.last_find) == {"dense"}


@pytest.mark.parametrize("k", [5, 7])
def test_find_dense_sweep_high_k(k):
    c = _corpus(12000, 930 + k)
    pat = bytes(_corpus(18, 931 + k, b"ACGT"))
    _plant_fuzzy(c, pat, k, [77, 5003, 11900], 932)
    _three_way_find([pat], k, c, chunk_bytes=4096)


def test_find_mixed_eligibility_multichunk():
    c = _corpus(20000, 940)
    long_pat, short_pat = bytes(_corpus(50, 941, b"ACGT")), bytes(_corpus(6, 942, b"ACGT"))
    _plant_fuzzy(c, long_pat, 2, [1000, 9000, 17000], 943)
    _three_way_find([short_pat, long_pat, short_pat], 2, c, chunk_bytes=8192)


def test_find_bits_fallback(monkeypatch):
    # rows past POS_CAP on both paths: the packed mask is fetched
    monkeypatch.setattr(jfused, "POS_CAP", 8)
    monkeypatch.setattr(tfused, "POS_CAP", 8)
    c = np.full(9000, ord("A"), dtype=np.uint8)
    tsc = _three_way_find([b"A" * 8, b"A" * 48], 2, c, chunk_bytes=4096)
    assert tsc.last_find["filter"]["bits"] > 0 and tsc.last_find["dense"]["bits"] > 0


def test_find_gpos_branch(monkeypatch):
    # more hot rows than FIND_BATCH with few hits each: the sweep's per-row
    # positions (gpos) are decoded in one fetch
    monkeypatch.setattr(jfused, "FIND_BATCH", 8)
    monkeypatch.setattr(tfused, "FIND_BATCH", 8)
    c = _corpus(40000, 950)
    pat = bytes(_corpus(8, 951, b"ACGT"))
    for pos in range(50, 39000, 300):
        c[pos : pos + 8] = np.frombuffer(pat, np.uint8)
    tsc = _three_way_find([pat], 2, c, chunk_bytes=8192)
    assert tsc.last_find["dense"]["gpos"] > 0


def test_find_gather_batches(monkeypatch):
    # more hot rows than FIND_BATCH on the filtration path: gather batches
    # re-verify the rest, and POS_CAP forces some of them to the bits
    monkeypatch.setattr(jfused, "FIND_BATCH", 8)
    monkeypatch.setattr(tfused, "FIND_BATCH", 8)
    c = _corpus(40000, 960)
    pat = bytes(_corpus(50, 961, b"ACGT"))
    _plant_fuzzy(c, pat, 2, list(range(100, 39000, 977)), 962)
    c[20000:20600] = ord("A")
    tsc = _three_way_find([pat, b"A" * 40], 2, c, chunk_bytes=8192)
    stats = tsc.last_find["filter"]
    assert stats["gather"] > 0 and stats["rows"] > 0


def test_find_torch_backend_uses_the_device_layout(monkeypatch):
    # backend="torch" runs the device-position layout on the plain versions
    c = _corpus(5000, 970)
    pat = bytes(_corpus(40, 971, b"ACGT"))
    _plant_fuzzy(c, pat, 1, [10, 2500], 972)
    tsc = apm_torch.Scanner([pat], 1, ApmConfig(device="cpu", backend="torch", block_windows=1024))
    calls = []
    fn = tfused.find_positions_chunk
    monkeypatch.setattr(tfused, "find_positions_chunk", lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    assert tsc.find(c)[0].tolist() == _oracle_positions(c, pat, 1)
    assert calls


def test_find_constants_match_apm():
    for name in ("FIND_BATCH", "POS_CAP", "SWEEP_MASK_BYTES"):
        assert getattr(tfused, name) == getattr(jfused, name), name


@pytest.mark.parametrize("k", [16383, 20000])
def test_find_past_16_bit_cells(k):
    # k past the card's paired 16-bit band cells, patterns of at most 16
    # bytes: every window start below n - k matches. Held to the port's
    # oracle and to the reference's square Levenshtein (apm.utils.oracle,
    # no band) window by window; apm's find is not run here: its band of
    # 2k + 1 diagonals is too slow for a CPU test at this k.
    from apm.utils.oracle import levenshtein_square
    from apm_torch.utils.oracle import banded_distances as port_distances

    c = _corpus(k + 2500, 980 + k % 7)
    pats = [bytes(c[300:312]), b"ACGTTGCAACGTTGCA"]
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=1024))
    got = tsc.find(c)
    assert tsc.count(c).tolist() == [len(c) - k] * 2
    for pi, pat in enumerate(pats):
        want = [j for j in range(len(c) - k)
                if levenshtein_square(pat, c[j : j + len(pat)]) <= k]
        assert got[pi].tolist() == want == list(range(len(c) - k))
        assert np.nonzero(port_distances(c, pat, k) <= k)[0].tolist() == want
    assert set(tsc.last_find) == {"dense"}
