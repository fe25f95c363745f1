"""NumPy models of the mask kernels' steps (TPU kernel #6, ``csrc/dp_mask.cu``)
held against the plain mask mode and against apm (Pallas in interpret mode).

The CUDA kernels run only on the card; this file argues their arithmetic
where no card is present. Each model repeats its kernel's design step for
step on NumPy arrays, every window pair of every tile at once:

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

K_WIN = 512  # windows a tile: 256 threads, two windows each
K_REG_MAX = 16  # widest band half-width in registers
K_RENORM = 1 << 14  # band steps between clamps of the cells
ONE2 = np.uint32(0x00010001)
WF = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the DPX forms on NumPy uint32 words (two 16-bit halves) ------------------


def _halves(w):
    return w & np.uint32(0xFFFF), w >> np.uint32(16)


def _join(lo, hi):
    return (lo & np.uint32(0xFFFF)) | ((hi & np.uint32(0xFFFF)) << np.uint32(16))


def viaddmin_u16x2(a, b, c):
    """Per half: min((a + b) mod 2^16, c)."""
    (al, ah), (bl, bh), (cl, ch) = _halves(a), _halves(b), _halves(c)
    return _join(np.minimum((al + bl) & np.uint32(0xFFFF), cl),
                 np.minimum((ah + bh) & np.uint32(0xFFFF), ch))


def vimin3_u16x2(a, b, c):
    (al, ah), (bl, bh), (cl, ch) = _halves(a), _halves(b), _halves(c)
    return _join(np.minimum(np.minimum(al, bl), cl), np.minimum(np.minimum(ah, bh), ch))


def vminu2(a, b):
    (al, ah), (bl, bh) = _halves(a), _halves(b)
    return _join(np.minimum(al, bl), np.minimum(ah, bh))


# -- staging ------------------------------------------------------------------


def _tiles(rows, wf, m_max):
    """(R, n_tiles, kWin + m_max) staged text (zeros past each row's end)."""
    n_rows, stride = rows.shape
    n_tiles = -(-wf // K_WIN)
    width = K_WIN + m_max
    padded = np.zeros((n_rows, (n_tiles - 1) * K_WIN + width), np.uint8)
    padded[:, : min(stride, padded.shape[1])] = rows[:, : padded.shape[1]]
    return np.stack([padded[:, l : l + width] for l in range(0, n_tiles * K_WIN, K_WIN)], axis=1)


def _mask_out(hits, rows, wf, bound, start, n_pat):
    """(counts (P,), mask (R, P, wf)) from per-pattern (R, n_tiles, 256, 2)
    verdict pairs: ownership applied, lanes past wf dropped."""
    n_rows = rows.shape[0]
    lane = np.arange(hits.shape[2] * K_WIN).reshape(1, -1)
    own = (start + np.arange(n_rows).reshape(-1, 1) * wf + lane) < bound
    mask = np.zeros((n_rows, n_pat, wf), np.uint8)
    for p, h in enumerate(hits):
        flat = (h.reshape(n_rows, -1) & own).astype(np.uint8)
        mask[:, p] = flat[:, :wf]
    return mask.sum(axis=(0, 2)).astype(np.int32), mask


# -- band mode -----------------------------------------------------------------


def _inc(v):
    """``v + 0x00010001``: the halves never carry."""
    assert int(_halves(v)[0].max()) < 0xFFFF and int(_halves(v)[1].max()) < 0xFFFF
    return v + ONE2


def _band_pairs(staged, pat_row, m, k, ke, renorm=K_RENORM):
    """Verdict pairs (R, n_tiles, 256, 2) of one pattern, the register path:
    paired 16-bit cells, the DPX step."""
    bw = 2 * ke + 1
    pw = pat_row.astype(np.uint32) * ONE2  # the shared table's words
    pp = pw[k - ke :]
    splat = lambda v: np.uint32(v) * ONE2
    cap, cap1 = splat(k + 1), splat(k + 2)
    shape = staged.shape[:2] + (K_WIN // 2,)
    txt = staged.astype(np.uint32)
    v = [np.full(shape, splat(di - ke) if di >= ke else cap, np.uint32) for di in range(bw)]
    u = [_inc(c) for c in v]
    pc = [splat(0)] + [pp[di] for di in range(bw - 1)]
    even = np.arange(0, K_WIN, 2)
    hi = txt[:, :, even]  # byte x - 1 of window 2t at x = 1, carried over
    for x in range(1, m + 1):
        pc = pc[1:] + [pp[x - 1 + bw - 1]]
        lo, hi = hi, txt[:, :, even + x]
        t2 = _join(lo, hi)
        uprev = None
        for di in range(bw):
            c = viaddmin_u16x2(v[di], t2 ^ pc[di], u[di])
            if di + 1 < bw:
                c = vimin3_u16x2(c, u[di + 1], uprev) if di > 0 else vminu2(c, u[di + 1])
            elif di > 0:
                c = vminu2(c, uprev)
            if x <= ke:  # the boundary steps
                y = x + di - ke
                if y == 0:
                    c = np.full(shape, splat(x), np.uint32)
                elif y < 0:
                    c = np.full(shape, cap, np.uint32)
            v[di] = c
            u[di] = _inc(c)
            uprev = u[di]
        if x > ke and ((x - ke) % renorm == 0 or x == m):  # a chunk's end: clamp
            v = [vminu2(c, cap1) for c in v]
            u = [_inc(c) for c in v]
    lo, hi = _halves(v[ke])
    return np.stack([lo <= k, hi <= k], axis=-1)


def _band_wide(staged, pat_row, m, k, ke):
    """Kernel A's one-window int32 path (bands wider than kRegMax), for
    each window of each pair."""
    bw = 2 * ke + 1
    cap = k + 1
    pp = pat_row[k - ke :].astype(np.int64)
    out = []
    for j in (0, 1):
        idx = np.arange(0, K_WIN, 2) + j
        shape = staged.shape[:2] + (K_WIN // 2,)
        cell = [np.full(shape, di - ke if di >= ke else cap, np.int64) for di in range(bw)]
        for x in range(1, m + 1):
            t = staged[:, :, idx + x - 1].astype(np.int64)
            prev = np.full(shape, cap, np.int64)
            new = []
            for di in range(bw):
                y = x + di - ke
                nxt = cell[di + 1] if di + 1 < bw else np.full(shape, cap, np.int64)
                v = cell[di] + (t != pp[x - 1 + di])
                v = np.minimum(np.minimum(v, nxt + 1), np.minimum(prev + 1, cap))
                if y == 0:
                    v = np.full(shape, x, np.int64)
                if y < 0:
                    v = np.full(shape, cap, np.int64)
                new.append(v)
                prev = v
            cell = new
        out.append(cell[ke] <= k)
    return np.stack(out, axis=-1)


def band_mask_model(rows, pat, bound, start, *, k, m_max, wf, plens, renorm=K_RENORM):
    """The band mask kernel's outputs, ``(counts, mask)``; ``renorm``: steps
    between the clamps (the kernel's kRenorm)."""
    ke = min(k, m_max)
    staged = _tiles(rows, wf, m_max)
    hits = []
    for p, m in enumerate(plens):
        if not 0 < m <= m_max:
            hits.append(np.zeros(staged.shape[:2] + (K_WIN // 2, 2), bool))
        elif ke <= K_REG_MAX:
            hits.append(_band_pairs(staged, pat[p], m, k, ke, renorm))
        else:
            hits.append(_band_wide(staged, pat[p], m, k, ke))
    return _mask_out(np.stack(hits), rows, wf, bound, start, len(plens))


# -- Myers mode ----------------------------------------------------------------


def _bit_step(vp, vn, cc, eq, mask, cbit, one=np.uint32(1)):
    """Hyyro's step on uint32 words; ``one`` = 0x00010001 when two windows
    share each word (16-bit fields, ``cc`` two 16-bit counts)."""
    xv = eq | vn
    xh = (((eq & vp) + vp) ^ vp) | eq
    ph = vn | (~(xh | vp) & mask)
    mh = vp & xh
    ph = ((ph << np.uint32(1)) & mask) | one
    mh = (mh << np.uint32(1)) & mask
    cc = cc + one - (((xh | vn) >> np.uint32(cbit)) & one)
    return mh | (~(xv | ph) & mask), ph & xv, cc


def _myers_packed(ch, peq, base, m, k):
    """Verdict pairs of one pattern with both windows in one word."""
    bw = 2 * k + 1
    assert bw <= 15
    mask = np.uint32((1 << bw) - 1) * ONE2
    top = np.uint32(1 << (bw - 1)) * ONE2
    even = np.arange(0, K_WIN, 2)
    shape = ch.shape[:2] + (K_WIN // 2,)
    st = [np.full(shape, mask, np.uint32), np.zeros(shape, np.uint32), np.zeros(shape, np.uint32)]
    hi = ch[:, :, even]
    for x in range(1, min(k, m) + 1):
        lo, hi = hi, ch[:, :, even + x]
        eq = peq[base + k][lo] | (peq[base + k][hi] << np.uint32(16))
        st = list(_bit_step(*st, eq, mask, x - 1, ONE2))
    if m > k:
        st[0] = ((st[0] << np.uint32(1)) | ONE2) & mask
        st[1] = (st[1] << np.uint32(1)) & mask
        for x in range(k + 1, m + 1):
            st[0] = ((st[0] >> np.uint32(1)) & mask) | top
            st[1] = (st[1] >> np.uint32(1)) & mask
            lo, hi = hi, ch[:, :, even + x]
            eq = peq[base + x - 1][lo] | (peq[base + x - 1][hi] << np.uint32(16))
            st = list(_bit_step(*st, eq, mask, k, ONE2))
    cc_lo, cc_hi = _halves(st[2])
    return np.stack([cc_lo <= k, cc_hi <= k], axis=-1)


def myers_mask_model(rows, pat, bound, start, *, k, m_max, wf, plens, alphabet, packed=None):
    """The Myers mask kernel's outputs, ``(counts, mask)``: channels staged
    once a tile, the PEQ table with a zero column, both windows in one word
    where ``packed`` (the kernel's choice, 2k + 1 <= 15, by default), else
    two chains a thread."""
    if packed is None:
        packed = 2 * k + 1 <= 15
    n_chan = len(alphabet)
    peq = dp_kernel.build_peq(pat, k, m_max, alphabet).astype(np.uint32)
    peq = np.concatenate([peq, np.zeros((peq.shape[0], 1), np.uint32)], axis=1)  # (P*m, C + 1)
    lut = np.full(256, n_chan, np.int64)
    lut[list(alphabet)] = np.arange(n_chan)
    staged = _tiles(rows, wf, m_max)
    # bytes past the row's end are staged as the zero column too
    ch = lut[staged]
    n_rows, stride = rows.shape
    n_tiles = staged.shape[1]
    past = (np.arange(n_tiles).reshape(-1, 1) * K_WIN + np.arange(staged.shape[2])) >= stride
    ch[:, past] = n_chan
    bw = 2 * k + 1
    mask = np.uint32((1 << bw) - 1)
    topbit = np.uint32(1 << (bw - 1))
    even = np.arange(0, K_WIN, 2)
    shape = staged.shape[:2] + (K_WIN // 2,)
    hits = []
    for p, m in enumerate(plens):
        if m == 0:
            hits.append(np.zeros(shape + (2,), bool))
            continue
        base = p * m_max
        if packed:
            hits.append(_myers_packed(ch, peq, base, m, k))
            continue
        s = [[np.full(shape, mask, np.uint32), np.zeros(shape, np.uint32), np.zeros(shape, np.uint32)]
             for _ in (0, 1)]
        hi = ch[:, :, even]
        for x in range(1, min(k, m) + 1):  # static band: PEQ row k
            lo, hi = hi, ch[:, :, even + x]
            for st, c in zip(s, (lo, hi)):
                st[:] = _bit_step(*st, peq[base + k][c], mask, x - 1)
        if m > k:
            for st in s:
                st[0] = ((st[0] << np.uint32(1)) | np.uint32(1)) & mask
                st[1] = (st[1] << np.uint32(1)) & mask
            for x in range(k + 1, m + 1):
                lo, hi = hi, ch[:, :, even + x]
                for st, c in zip(s, (lo, hi)):
                    st[0] = (st[0] >> np.uint32(1)) | topbit
                    st[1] = st[1] >> np.uint32(1)
                    st[:] = _bit_step(*st, peq[base + x - 1][c], mask, k)
        hits.append(np.stack([s[0][2] <= k, s[1][2] <= k], axis=-1))
    return _mask_out(np.stack(hits), rows, wf, bound, start, len(plens))


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
