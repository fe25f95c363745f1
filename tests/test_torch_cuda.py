"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with a card (and no JAX) run them with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) Counts are
integers: the kernel must equal its plain version exactly.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _corpus(n, seed, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


@pytest.mark.parametrize("k", [0, 1, 3, 16, 17])
def test_dp_kernel_matches_plain(dev, k):
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus, round_up
    from apm_torch.utils.io import PatternSet

    wf, n_rows = 1024, 64
    corpus = _corpus(n_rows * wf + 512, 1 + k)
    pats = [bytes(corpus[100:130]), bytes(corpus[5000:5041]), b"ACGTTGCA"]
    packed, _ = PatternSet.from_patterns(pats).packed(k)
    pat = np.zeros((8, packed.shape[1]), np.uint8)
    pat[:3] = packed
    plens = (30, 41, 8, 0, 0, 0, 0, 0)
    halo = round_up(41 + 2 * k, 128)
    rows = torch.from_numpy(fold_corpus(corpus, 2 * wf, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    kw = dict(k=k, m_max=41, wf=wf, halo=halo, plens=plens)
    bound = 2 * wf + (n_rows - 3) * wf + 333
    before = dp_kernel.LAUNCHES
    got = dp_kernel.scan_folded_dp(rows, dpat, bound, 2 * wf, **kw)
    ref = dp_kernel.scan_folded_dp_ref(rows, dpat, bound, 2 * wf, **kw)
    assert dp_kernel.LAUNCHES == before + 1
    assert got.tolist() == ref.tolist()


@pytest.mark.parametrize("lengths", [[32, 50], [20] * 40, [70, 80]])
def test_corr_kernel_matches_plain(dev, lengths):
    from apm_torch.ops import corr_fused
    from apm_torch.ops.corr_engine import build_alphabet
    from apm_torch.ops.common import fold_corpus

    wf, halo, n_rows = 1024, 128, 48
    corpus = _corpus(n_rows * wf + 512, 9)
    pats = [bytes(_corpus(m, 50 + i)) for i, m in enumerate(lengths)]
    for i, p in enumerate(pats):
        corpus[300 + 997 * i : 300 + 997 * i + len(p)] = np.frombuffer(p, np.uint8)
    m_max = max(lengths)
    pat_raw = np.zeros((len(pats), m_max), np.uint8)
    for i, p in enumerate(pats):
        pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)
    km, thr = corr_fused.build_fused_tables(pat_raw, lengths, alph)
    tabs = corr_fused.FusedTables.from_numpy(
        km, thr, alph, corr_fused.pick_s(m_max), dev
    )
    rows = torch.from_numpy(fold_corpus(corpus, 0, n_rows, wf, halo)).to(dev)
    kw = dict(wf=wf, halo=halo, n_rows=n_rows - 2, p_out=8)
    bound = (n_rows - 3) * wf + 500
    got = corr_fused.scan_corr_fused(rows, tabs, bound, 0, **kw)
    ref = corr_fused.scan_corr_fused_ref(rows, tabs, bound, 0, **kw)
    assert got.tolist() == ref.tolist()
    assert int(got.sum()) >= len(pats)


@pytest.mark.parametrize("k", [0, 2])
def test_scanner_on_card_matches_oracle(dev, k):
    import apm_torch
    from apm_torch.utils.oracle import count_matches

    c = _corpus(200_000, 3 + k, b"ACGT\n")
    pats = [bytes(c[1000:1050]), bytes(c[7000:7032]), bytes(c[1000:1050])]
    sc = apm_torch.Scanner(pats, k)
    assert sc.count(c).tolist() == count_matches(c, pats, k)


def _tables(pats, k, n_pad=8):
    from apm_torch.ops.common import round_up
    from apm_torch.utils.io import PatternSet

    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    pat = np.zeros((n_pad, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    raw = np.zeros((n_pad, ps.max_len), np.uint8)
    raw[: len(pats)] = ps.table
    plens = tuple(len(p) for p in pats) + (0,) * (n_pad - len(pats))
    return pat, raw, plens, ps.max_len, round_up(ps.max_len + 2 * k, 128)


@pytest.mark.parametrize("k", [1, 3, 8, 14])
def test_myers_kernel_matches_plain_and_band(dev, k):
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows = 1024, 64
    corpus = _corpus(n_rows * wf + 512, 20 + k, b"ACGTN")
    pats = [bytes(corpus[100:130]), bytes(corpus[5000:5050]), b"ACGTTGCAAC"]
    pat, _, plens, m_max, halo = _tables(pats, k)
    alph = tuple(sorted(set(b"".join(pats))))
    rows = torch.from_numpy(fold_corpus(corpus, 2 * wf, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=alph)
    bound = 2 * wf + (n_rows - 3) * wf + 333
    before = (dp_kernel.LAUNCHES, dp_kernel.MYERS_LAUNCHES)
    got = dp_kernel.scan_folded_dp(rows, dpat, bound, 2 * wf, dp_impl="myers", **kw)
    band = dp_kernel.scan_folded_dp(rows, dpat, bound, 2 * wf, dp_impl="band", **kw)
    ref = dp_kernel.scan_folded_myers_ref(rows, dpat, bound, 2 * wf, **kw)
    assert (dp_kernel.LAUNCHES, dp_kernel.MYERS_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert got.tolist() == ref.tolist() == band.tolist()
    assert int(got.sum()) > 0


@pytest.mark.parametrize("dp_impl", ["band", "myers"])
def test_dp_kernels_read_a_device_bound(dev, dp_impl):
    # phase 2 passes min(n_hot, bucket) * wf as a tensor on the card
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows, k = 1024, 32, 3
    corpus = _corpus(n_rows * wf + 512, 31)
    pats = [bytes(corpus[300:332]), bytes(corpus[9000:9050])]
    pat, _, plens, m_max, halo = _tables(pats, k)
    rows = torch.from_numpy(fold_corpus(corpus, 0, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens,
              alphabet=tuple(b"ACGT"), dp_impl=dp_impl)
    for bound in (0, 5 * wf + 17, n_rows * wf - m_max + 1):
        want = dp_kernel.scan_folded_dp(rows, dpat, bound, 0, **kw)
        for dtype in (torch.int32, torch.int64):
            dbound = torch.tensor(bound, dtype=dtype, device=dev)
            got = dp_kernel.scan_folded_dp(rows, dpat, dbound, 0, **kw)
            assert got.tolist() == want.tolist()


@pytest.mark.parametrize(
    "k,lengths",
    [(0, [12, 20]), (1, [32, 50]), (3, [32, 50]), (5, [84, 50]), (8, [120, 120]), (16, [160, 160])],
)
def test_filter_kernel_matches_plain(dev, k, lengths):
    from apm_torch.ops import filter_kernel
    from apm_torch.ops.common import fold_corpus
    from apm_torch.utils.corpus import plant

    wf, n_rows = 1024, 48
    corpus = _corpus(n_rows * wf + 1024, 40 + k)
    pats = [bytes(_corpus(m, 60 + i)) for i, m in enumerate(lengths)]
    for i, p in enumerate(pats):
        plant(corpus, np.frombuffer(p, np.uint8), range(200 + 77 * i, len(corpus) - 400, 3001),
              k=min(k, 3), seed=i)
    _, raw, plens, m_max, halo = _tables(pats, k)
    rows = torch.from_numpy(fold_corpus(corpus, wf, n_rows, wf, halo)).to(dev)
    draw = torch.from_numpy(raw).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
    bound = wf + (n_rows - 5) * wf + 611
    before = filter_kernel.LAUNCHES
    fcnt, rowmap = filter_kernel.scan_filter(rows, draw, bound, wf, **kw)
    rf, rr = filter_kernel.scan_filter_ref(rows, draw, bound, wf, **kw)
    assert filter_kernel.LAUNCHES == before + 1
    assert fcnt.tolist() == rf.tolist()
    assert torch.equal(rowmap, rr)
    assert int(fcnt.sum()) > 0


@pytest.mark.parametrize("k", [3, 8])
def test_scanner_filtration_on_card_matches_oracle(dev, k):
    import apm_torch
    from apm_torch.ops import dp_kernel, filter_kernel
    from apm_torch.utils.corpus import plant
    from apm_torch.utils.oracle import count_matches

    c = _corpus(300_000, 70 + k, b"ACGT\n")
    lengths = [32, 50] if k == 3 else [120, 120]
    pats = [bytes(_corpus(m, 80 + i)) for i, m in enumerate(lengths)]
    for i, p in enumerate(pats):
        plant(c, np.frombuffer(p, np.uint8), range(1000 + 300 * i, len(c) - 200, 20_000),
              k=3, seed=i)
    before = (filter_kernel.LAUNCHES, dp_kernel.MYERS_LAUNCHES)
    sc = apm_torch.Scanner(pats, k)
    assert sc.count(c).tolist() == count_matches(c, pats, k)
    assert filter_kernel.LAUNCHES > before[0] and dp_kernel.MYERS_LAUNCHES > before[1]
