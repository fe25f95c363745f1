"""Kernel A's plain version against apm's banded Pallas kernel.

``scan_folded_dp_ref`` (and the ``scan_folded_dp`` wrapper, which takes it
for CPU tensors) must give exactly the counts of
``apm.ops.pallas_kernel.scan_folded_pallas_unrolled(..., interpret=True,
dp_impl="band")`` on the same staged rows. Counts are integers: tolerance 0.
The CUDA kernel itself is compared with the same plain version on the card
(``chip_smoke.py`` phase 2, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from apm_torch.ops import dp_kernel
from apm_torch.ops.common import fold_corpus, round_up
from apm_torch.utils.io import PatternSet

WF = 256


def _corpus(n, seed, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


def _setup(lengths, k, n_rows, seed, start_row=0, n_pad=8):
    """Corpus with planted (mutated) pattern copies, its staged rows and the
    k-padded pattern table, padded to n_pad slots."""
    from apm_torch.utils.corpus import plant

    corpus = _corpus((start_row + n_rows) * WF + 512, seed)
    pats = []
    for i, m in enumerate(lengths):
        p = _corpus(m, seed + 100 + i)
        plant(corpus, p, range(37 + 53 * i, len(corpus) - 200, 701), k=min(k, 2),
              seed=seed + i)
        pats.append(p.tobytes())
    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    pat = np.zeros((n_pad, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    plens = tuple(lengths) + (0,) * (n_pad - len(pats))
    halo = round_up(ps.max_len + 2 * k, 128)
    rows = fold_corpus(corpus, start_row * WF, n_rows, WF, halo)
    return rows, pat, plens, ps.max_len, halo


def _apm(rows, pat, bound, start, k, m_max, halo, plens):
    import jax.numpy as jnp

    from apm.ops.pallas_kernel import scan_folded_pallas_unrolled

    return np.asarray(
        scan_folded_pallas_unrolled(
            jnp.asarray(rows), jnp.asarray(pat),
            jnp.asarray(bound, jnp.int32), jnp.asarray(start, jnp.int32),
            k=k, m_max=m_max, wf=WF, halo=halo, plens=plens,
            interpret=True, dp_impl="band",
        )
    )


def _port(rows, pat, bound, start, k, m_max, halo, plens):
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens)
    r, p = torch.from_numpy(rows), torch.from_numpy(pat)
    ref = dp_kernel.scan_folded_dp_ref(r, p, bound, start, **kw)
    wrapped = dp_kernel.scan_folded_dp(r, p, bound, start, **kw)
    assert ref.dtype == torch.int32 and ref.shape == (pat.shape[0],)
    assert torch.equal(ref, wrapped)
    return ref.numpy()


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5])
def test_dp_ref_matches_apm_band(k):
    n_rows = 16
    rows, pat, plens, m_max, halo = _setup([24, 40], k, n_rows, seed=10 + k)
    bound = n_rows * WF - m_max + 1
    want = _apm(rows, pat, bound, 0, k, m_max, halo, plens)
    got = _port(rows, pat, bound, 0, k, m_max, halo, plens)
    assert want.sum() > 0
    assert got.tolist() == want.tolist()


def test_dp_ref_mixed_lengths_padding_start_and_mid_row_bound():
    k, n_rows, start_row = 2, 16, 3
    rows, pat, plens, m_max, halo = _setup(
        [5, 13, 29, 47, 61], k, n_rows, seed=30, start_row=start_row
    )
    start = start_row * WF
    bound = start + 11 * WF + 77  # mid-row: row 11 owns 77 windows
    want = _apm(rows, pat, bound, start, k, m_max, halo, plens)
    got = _port(rows, pat, bound, start, k, m_max, halo, plens)
    assert want[:5].sum() > 0 and not want[5:].any()
    assert got.tolist() == want.tolist()


def test_dp_ref_short_patterns_below_k():
    # m_p <= k: every window is within distance k; the boundary steps
    # carry the whole scan.
    k, n_rows = 4, 8
    rows, pat, plens, m_max, halo = _setup([3, 4, 9], k, n_rows, seed=40)
    bound = n_rows * WF - m_max + 1 - 9
    want = _apm(rows, pat, bound, 0, k, m_max, halo, plens)
    got = _port(rows, pat, bound, 0, k, m_max, halo, plens)
    assert got.tolist() == want.tolist()
    assert got[0] == got[1] == bound


def test_dp_wrapper_checks_its_inputs():
    rows, pat, plens, m_max, halo = _setup([10], 1, 8, seed=50)
    r, p = torch.from_numpy(rows), torch.from_numpy(pat)
    kw = dict(k=1, m_max=m_max, wf=WF, halo=halo, plens=plens)
    with pytest.raises(ValueError):
        dp_kernel.scan_folded_dp(r.to(torch.int32), p, 100, 0, **kw)
    with pytest.raises(ValueError):
        dp_kernel.scan_folded_dp(r[:, 1:], p, 100, 0, **kw)
    with pytest.raises(ValueError):
        dp_kernel.scan_folded_dp(r, p[:, 1:], 100, 0, **kw)
    with pytest.raises(ValueError):
        dp_kernel.scan_folded_dp(r, p, 100, 0, **{**kw, "plens": plens[:-1]})
    # a CPU tensor never reaches the kernel or its launch counter
    before = dp_kernel.LAUNCHES
    dp_kernel.scan_folded_dp(r, p, 100, 0, **kw)
    assert dp_kernel.LAUNCHES == before
