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
