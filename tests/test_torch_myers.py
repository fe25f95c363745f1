"""Kernel C's plain version (the bit-parallel band) against apm's Myers mode.

``scan_folded_myers_ref`` must give exactly the counts of
``apm.ops.pallas_kernel.scan_folded_pallas_unrolled(..., interpret=True,
dp_impl="myers")`` and of the classic band (``scan_folded_dp_ref``) on the
same staged rows, and ``scan_folded_dp`` must pick the bit-parallel band
exactly where apm's ``resolve_dp_mode`` does. Counts are integers:
tolerance 0. The CUDA kernel itself is compared with the same plain version
on the card (``chip_smoke.py`` phase 2b, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from apm_torch.ops import dp_kernel
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


def _setup(lengths, k, n_rows, seed, pat_alphabet=b"ACGT", text_alphabet=b"ACGTN\n",
           start_row=0):
    """Staged rows (text bytes may lie outside the patterns' alphabet), the
    k-padded table padded to 8 slots, static lengths and the alphabet."""
    rng = np.random.default_rng(seed)
    ta = np.frombuffer(text_alphabet, np.uint8)
    pa = np.frombuffer(pat_alphabet, np.uint8)
    corpus = ta[rng.integers(0, len(ta), (start_row + n_rows) * WF + 512)]
    pats = []
    for i, m in enumerate(lengths):
        p = pa[rng.integers(0, len(pa), m)]
        plant(corpus, p, range(41 + 67 * i, len(corpus) - 300, 389), k=min(k, 3),
              seed=seed + i)
        pats.append(p.tobytes())
    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    pat = np.zeros((8, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    plens = tuple(lengths) + (0,) * (8 - len(lengths))
    alph = tuple(sorted(set(b"".join(pats))))
    halo = round_up(ps.max_len + 2 * k, 128)
    rows = fold_corpus(corpus, start_row * WF, n_rows, WF, halo)
    return rows, pat, plens, ps.max_len, halo, alph


def _apm_myers(rows, pat, bound, start, k, m_max, halo, plens, alph):
    import jax.numpy as jnp

    from apm.ops.pallas_kernel import scan_folded_pallas_unrolled

    return np.asarray(
        scan_folded_pallas_unrolled(
            jnp.asarray(rows), jnp.asarray(pat),
            jnp.asarray(bound, jnp.int32), jnp.asarray(start, jnp.int32),
            k=k, m_max=m_max, wf=WF, halo=halo, plens=plens,
            interpret=True, alphabet=alph, dp_impl="myers",
        )
    )


@pytest.mark.parametrize(
    "k,lengths,pat_alphabet",
    [
        (1, [24, 40], b"AC"),
        (3, [32, 50], b"ACGT"),
        (4, [9, 50, 50], b"ACGTN"),
        (8, [40, 33], b"ACGTNRYK"),
        (14, [50, 20], b"ACGT"),
    ],
)
def test_myers_ref_matches_apm_and_band(k, lengths, pat_alphabet):
    n_rows = 8
    rows, pat, plens, m_max, halo, alph = _setup(
        lengths, k, n_rows, seed=20 + k, pat_alphabet=pat_alphabet
    )
    assert 2 <= len(alph) <= 8
    bound = n_rows * WF - m_max + 1 - 37
    want = _apm_myers(rows, pat, bound, 0, k, m_max, halo, plens, alph)
    r, p = torch.from_numpy(rows), torch.from_numpy(pat)
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens)
    got = dp_kernel.scan_folded_myers_ref(r, p, bound, 0, alphabet=alph, **kw)
    band = dp_kernel.scan_folded_dp_ref(r, p, bound, 0, **kw)
    assert got.dtype == torch.int32 and got.shape == (8,)
    assert want[: len(lengths)].sum() > 0
    assert got.tolist() == want.tolist() == band.tolist()
    # the wrapper's CPU route: the same dispatch, no launch
    before = (dp_kernel.LAUNCHES, dp_kernel.MYERS_LAUNCHES)
    wrapped = dp_kernel.scan_folded_dp(r, p, bound, 0, alphabet=alph, dp_impl="myers", **kw)
    assert wrapped.tolist() == got.tolist()
    assert (dp_kernel.LAUNCHES, dp_kernel.MYERS_LAUNCHES) == before


def test_myers_ref_start_device_bound_and_short_patterns():
    # start > 0, a mid-row bound given as a 0-d tensor (phase 2's device
    # bound), and patterns shorter than k (static phase only)
    k, n_rows, start_row = 6, 8, 3
    rows, pat, plens, m_max, halo, alph = _setup(
        [4, 6, 45], k, n_rows, seed=31, start_row=start_row
    )
    start = start_row * WF
    bound = start + 5 * WF + 55
    want = _apm_myers(rows, pat, bound, start, k, m_max, halo, plens, alph)
    r, p = torch.from_numpy(rows), torch.from_numpy(pat)
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens, alphabet=alph)
    peq = torch.from_numpy(dp_kernel.build_peq(pat, k, m_max, alph))
    for b in (bound, torch.tensor(bound), torch.tensor(bound, dtype=torch.int32)):
        got = dp_kernel.scan_folded_myers_ref(r, p, b, start, peq=peq, **kw)
        assert got.tolist() == want.tolist()
    assert want[0] == want[1] == 5 * WF + 55  # m <= k: every window matches


def test_dp_dispatch_follows_resolve_dp_mode(monkeypatch):
    from apm.ops.pallas_kernel import resolve_dp_mode

    calls = []
    real = dp_kernel.scan_folded_myers_ref

    def spy(*a, **kw):
        calls.append("myers")
        return real(*a, **kw)

    monkeypatch.setattr(dp_kernel, "scan_folded_myers_ref", spy)
    big = tuple(range(9))  # nine channels: past MYERS_CMAX
    for k in (1, 2, 3, 4):
        rows, pat, plens, m_max, halo, alph = _setup([20, 30], k, 2, seed=5 + k)
        for alphabet in (alph, (), big):
            for impl in ("auto", "band", "myers"):
                calls.clear()
                dp_kernel.scan_folded_dp(
                    torch.from_numpy(rows), torch.from_numpy(pat), 300, 0,
                    k=k, m_max=m_max, wf=WF, halo=halo, plens=plens,
                    alphabet=alphabet, dp_impl=impl,
                )
                want = resolve_dp_mode(k, alphabet, "int32", impl, len(plens), m_max)[1]
                assert ("myers" if calls else "band") == want, (k, alphabet, impl)


def test_myers_wrapper_checks_its_inputs():
    rows, pat, plens, m_max, halo, alph = _setup([20], 3, 2, seed=9)
    r, p = torch.from_numpy(rows), torch.from_numpy(pat)
    kw = dict(k=3, m_max=m_max, wf=WF, halo=halo, plens=plens)
    with pytest.raises(ValueError):  # no alphabet
        dp_kernel.scan_folded_myers_ref(r, p, 100, 0, alphabet=(), **kw)
    with pytest.raises(ValueError):  # a PEQ table of the wrong shape
        dp_kernel.scan_folded_myers_ref(
            r, p, 100, 0, alphabet=alph, peq=torch.zeros((3, 4), dtype=torch.int32), **kw
        )
    with pytest.raises(ValueError):  # a bound tensor of two values
        dp_kernel.scan_folded_dp(r, p, torch.tensor([1, 2]), 0, alphabet=alph, **kw)


@pytest.mark.parametrize("dp_impl", ["auto", "band", "myers"])
def test_scan_folded_dp_plain_takes_the_same_mode(dp_impl, monkeypatch):
    """plain=True runs the plain version of the mode scan_folded_dp picks:
    the band ref, or the Myers ref exactly where _myers_mode says so."""
    rows, pat, plens, m_max, halo, alph = _setup([32, 50], 4, 8, 11)
    r, p = torch.from_numpy(rows), torch.from_numpy(pat)
    kw = dict(k=4, m_max=m_max, wf=WF, halo=halo, plens=plens)
    bound = r.shape[0] * WF - 17
    calls = []
    band, myers = dp_kernel.scan_folded_dp_ref, dp_kernel.scan_folded_myers_ref
    monkeypatch.setattr(dp_kernel, "scan_folded_dp_ref",
                        lambda *a, **k: calls.append("band") or band(*a, **k))
    monkeypatch.setattr(dp_kernel, "scan_folded_myers_ref",
                        lambda *a, **k: calls.append("myers") or myers(*a, **k))
    got = dp_kernel.scan_folded_dp(r, p, bound, 0, alphabet=alph, dp_impl=dp_impl,
                                   plain=True, **kw)
    on = dp_kernel._myers_mode(4, alph, "int32", dp_impl, len(plens), m_max)
    assert calls == ["myers" if on else "band"]
    assert torch.equal(got, band(r, p, bound, 0, **kw))


@pytest.mark.parametrize("dp_impl", ["auto", "band", "myers"])
@pytest.mark.parametrize("k", range(1, 15))
def test_plan_dp_mode_is_the_dispatched_branch(monkeypatch, k, dp_impl):
    """The plan's ``routes.dp_mode`` is the branch ``dp_kernel._dispatch``
    takes for the Scanner's banded-DP calls, and the Scanner passes its PEQ
    table exactly in Myers mode: alphabets of 4 and 9 bytes (past
    ``MYERS_CMAX``), P x m under and over the 64 KiB PEQ budget."""
    import apm_torch
    from apm_torch import ApmConfig
    from apm_torch.models.pipeline import make_plan

    taken, peqs = [], []
    zeros = lambda *a, **kw: torch.zeros((8,), dtype=torch.int32)
    monkeypatch.setattr(dp_kernel, "scan_folded_myers_ref",
                        lambda *a, **kw: taken.append("myers") or zeros())
    monkeypatch.setattr(dp_kernel, "scan_folded_dp_ref",
                        lambda *a, **kw: taken.append("band") or zeros())
    scan = dp_kernel.scan_folded_dp
    monkeypatch.setattr(dp_kernel, "scan_folded_dp",
                        lambda *a, peq=None, **kw: peqs.append(peq is not None)
                        or scan(*a, peq=peq, **kw))
    rng = np.random.default_rng(k)
    for alphabet in (b"ACGT", b"ACGTNRYKM"):
        a = np.frombuffer(alphabet, np.uint8)
        for m in (40, 520):  # 8 slots x m x C x 4 bytes: 5 / 66 KiB at C = 4
            assert (8 * m * 4 * 4 > dp_kernel.MYERS_SMEM_MAX) == (m == 520)
            pats = [np.concatenate([a, a[rng.integers(0, len(a), m - len(a))]]).tobytes()
                    for _ in range(3)]
            sc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", dp_impl=dp_impl))
            plan = make_plan(sc, 4096)
            rows = torch.zeros((8, plan.wf + plan.halo), dtype=torch.uint8)
            taken.clear(), peqs.clear()
            sc._scan_dp(plan, rows, plan.dev_bound, 0, sc._plens_static)
            assert taken == [plan.routes.dp_mode], (alphabet, m)
            assert peqs == [plan.routes.dp_mode == "myers"], (alphabet, m)
