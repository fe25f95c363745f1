"""NumPy models of the mask kernels' steps (TPU kernel #6, ``csrc/dp_mask.cu``)
held against the plain mask mode and against apm (Pallas in interpret mode).

The CUDA kernels run only on the card; this file argues their arithmetic
where no card is present. The step models (``tests/pair_models.py``, shared
with the count kernels' tests) repeat the kernels' design step for step on
NumPy arrays, every window pair of every tile at once:

* band mode: a tile stages ``kWin + m_max`` text bytes from its first lane
  (zeros past the row); the thread of lanes ``2t, 2t + 1`` keeps both
  windows' cells in the 16-bit halves of one word and advances them with
  the DPX forms (``__viaddmin_u16x2``, ``__vimin3_u16x2``, ``__vminu2``):
  ``v' = min(min(v + (t ^ p), u), u_next, u_prev')``, ``u' = v' + 1`` (a
  plain add, no clamp), the boundary cells of the first ``ke`` steps
  overwritten, the cells clamped at ``k + 2`` every ``kRenorm`` steps, the
  verdict ``v[ke] <= k`` per half; bands wider than ``kRegMax`` take
  kernel A's one-window int32 path;
* Myers mode: the tile's text staged as alphabet channels (the zero column
  for bytes outside the alphabet), the second window's channel carried
  over as the first's at the next step; up to k = 7 both windows packed
  into the 16-bit fields of one bit band (the add's carry kept inside each
  field's spare bits), else each thread's two windows advanced as two
  bit-vector chains.

Verdicts and counts are integers: the tolerance is 0. The card holds the
kernels themselves to the same plain version (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2d).
"""

import numpy as np
import pytest
import torch

from apm_torch.ops import dp_kernel
from apm_torch.ops.common import fold_corpus, round_up
from apm_torch.utils.io import PatternSet
from pair_models import (K_RENORM, K_WIN, band_verdicts, myers_verdicts, vimin3_u16x2,
                         viaddmin_u16x2, vminu2)

WF = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- outputs ----------------------------------------------------------------


def _mask_out(hits, rows, wf, bound, start, n_pat):
    """(counts (P,), mask (R, P, wf)) from per-pattern (R, n_tiles, 256, 2)
    verdict pairs (``pair_models``): ownership applied, lanes past wf
    dropped."""
    n_rows = rows.shape[0]
    lane = np.arange(hits.shape[2] * K_WIN).reshape(1, -1)
    own = (start + np.arange(n_rows).reshape(-1, 1) * wf + lane) < bound
    mask = np.zeros((n_rows, n_pat, wf), np.uint8)
    for p, h in enumerate(hits):
        flat = (h.reshape(n_rows, -1) & own).astype(np.uint8)
        mask[:, p] = flat[:, :wf]
    return mask.sum(axis=(0, 2)).astype(np.int32), mask


# -- band mode -----------------------------------------------------------------


def band_mask_model(rows, pat, bound, start, *, k, m_max, wf, plens, renorm=K_RENORM):
    """The band mask kernel's outputs, ``(counts, mask)``; ``renorm``: steps
    between the clamps (the kernel's kRenorm)."""
    hits = band_verdicts(rows, pat, k=k, m_max=m_max, wf=wf, plens=plens, renorm=renorm)
    return _mask_out(hits, rows, wf, bound, start, len(plens))


# -- Myers mode ----------------------------------------------------------------


def myers_mask_model(rows, pat, bound, start, *, k, m_max, wf, plens, alphabet, packed=None):
    """The Myers mask kernel's outputs, ``(counts, mask)``: both windows in
    one word where ``packed`` (the kernel's choice, 2k + 1 <= 15, by
    default), else two chains a thread."""
    hits = myers_verdicts(rows, pat, k=k, m_max=m_max, wf=wf, plens=plens, alphabet=alphabet,
                          packed=packed)
    return _mask_out(hits, rows, wf, bound, start, len(plens))


# -- the cases -------------------------------------------------------------------


def _case(text, k, lengths, n_rows=8, seed=0):
    """Staged rows, k-padded table (8 slots, padding included), lengths,
    m_max and halo of one case; random ACGT patterns planted into the text
    with up to min(k, 2) edits."""
    from apm_torch.utils.corpus import plant

    rng = np.random.default_rng(seed)
    n = (n_rows + 2) * WF + 256
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if text == "all-A":
        corpus = np.full(n, ord("A"), np.uint8)
        pats = [b"A" * m for m in lengths]
    else:
        letters = acgt if text == "random" else np.frombuffer(b"ACGT\x00N\xff", np.uint8)
        corpus = letters[rng.integers(0, len(letters), n)]
        pats = [acgt[rng.integers(0, 4, m)].tobytes() for m in lengths]
        for i, p in enumerate(pats):
            plant(corpus, np.frombuffer(p, np.uint8), range(40 + 97 * i, n - 200, 331),
                  k=min(k, 2), seed=seed + i)
    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    pat = np.zeros((8, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    plens = tuple(lengths) + (0,) * (8 - len(pats))
    halo = round_up(ps.max_len + 2 * k, 128)
    rows = fold_corpus(corpus, WF, n_rows, WF, halo)
    return rows, pat, plens, ps.max_len, halo


def _three_way(rows, pat, plens, m_max, halo, k, dp_impl, model, **model_kw):
    """Model, plain mask mode and apm's interpret-mode mask on one bound
    that leaves row 5 an odd number (77) of owned windows."""
    from apm.ops.pallas_kernel import scan_folded_pallas_mask

    start = WF
    bound = start + 5 * WF + 77
    alph = tuple(b"ACGT")
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens, alphabet=alph, dp_impl=dp_impl)
    assert dp_kernel._is_myers(k, m_max, plens, alph, dp_impl) == (model is myers_mask_model)
    if model is myers_mask_model:
        got_c, got_m = model(rows, pat, bound, start, k=k, m_max=m_max, wf=WF, plens=plens,
                             alphabet=alph, **model_kw)
    else:
        got_c, got_m = model(rows, pat, bound, start, k=k, m_max=m_max, wf=WF, plens=plens,
                             **model_kw)
    rc, rm = dp_kernel.scan_folded_dp_mask_ref(torch.from_numpy(rows), torch.from_numpy(pat),
                                                bound, start, **kw)
    jc, jm = scan_folded_pallas_mask(rows, pat, np.int32(bound), np.int32(start),
                                     interpret=True, **kw)
    assert got_c.tolist() == rc.tolist() == np.asarray(jc).tolist()
    assert np.array_equal(got_m, rm.numpy())
    assert np.array_equal(got_m, np.asarray(jm).astype(np.uint8))
    assert int(got_m[5].sum()) <= 77 * len(plens) and not got_m[6:].any()
    return got_c, got_m


@pytest.mark.parametrize(
    "k,lengths,text",
    [(0, [24, 40], "random"), (1, [24, 40], "random"), (2, [24, 40], "random"),
     (3, [24, 40], "random"),
     (2, [1, 2, 30], "random"),  # m < k, m = k, m = m_max
     (1, [24, 40], "foreign"),  # NUL and bytes outside ACGT
     (2, [3, 40], "all-A")],  # every owned window a hit
)
def test_band_pair_model_matches_plain_and_apm(k, lengths, text):
    rows, pat, plens, m_max, halo = _case(text, k, lengths, seed=10 + k)
    counts, mask = _three_way(rows, pat, plens, m_max, halo, k, "band", band_mask_model)
    assert counts.sum() > 0
    if text == "all-A":  # rows 0-4 whole, row 5 77 windows
        assert counts[:2].tolist() == [5 * WF + 77] * 2


@pytest.mark.parametrize("renorm", [1, 3])
def test_band_model_clamps_at_any_step(renorm):
    # the kernel clamps every kRenorm steps; any interval keeps the verdicts
    rows, pat, plens, m_max, halo = _case("random", 3, [24, 40], seed=50 + renorm)
    counts, _ = _three_way(rows, pat, plens, m_max, halo, 3, "band", band_mask_model,
                           renorm=renorm)
    assert counts.sum() > 0


@pytest.mark.parametrize("k", [16, 17])
def test_band_model_register_limit(k):
    # ke = 16 is the widest band in registers, ke = 17 takes the scratch path
    rows, pat, plens, m_max, halo = _case("random", k, [20, 18], n_rows=8, seed=60 + k)
    assert min(k, m_max) == k
    counts, _ = _three_way(rows, pat, plens, m_max, halo, k, "band", band_mask_model)
    assert counts.sum() > 0


@pytest.mark.parametrize("packed", [None, False], ids=["kernel-choice", "two-chains"])
@pytest.mark.parametrize(
    "k,lengths,text",
    [(1, [24, 40], "random"), (2, [24, 40], "random"), (3, [24, 40], "random"),
     (3, [2, 3, 30], "random"),  # m < k, m = k, m = m_max
     (2, [24, 40], "foreign"),  # NUL and bytes outside the alphabet: the zero column
     (3, [4, 40], "all-A"),
     (7, [24, 40], "random"), (8, [24, 40], "random")],  # the widest packed band, then two chains
)
def test_myers_pair_model_matches_plain_and_apm(k, lengths, text, packed):
    rows, pat, plens, m_max, halo = _case(text, k, lengths, seed=30 + k)
    counts, _ = _three_way(rows, pat, plens, m_max, halo, k, "myers", myers_mask_model,
                           packed=packed)
    assert counts.sum() > 0
    if text == "all-A":
        assert counts[:2].tolist() == [5 * WF + 77] * 2


def test_dpx_forms_wrap_and_saturate_per_half():
    # the halves never carry into each other, and the clamp bounds both
    a = np.array([0xFFFF0003, 0x0001FFFF], np.uint32)
    b = np.array([0x00010002, 0x00010001], np.uint32)
    assert viaddmin_u16x2(a, b, np.uint32(0x00130013)).tolist() == [0x00000005, 0x00020000]
    assert vimin3_u16x2(a, b, np.uint32(0x00020002)).tolist() == [0x00010002, 0x00010001]
    assert vminu2(a, b).tolist() == [0x00010002, 0x00010001]
