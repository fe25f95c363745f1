"""NumPy models of the paired-window kernels' steps (``csrc/dp_pair.cuh``),
shared by the mask kernels' tests (``test_torch_mask.py``) and the count
kernels' tests (``test_torch_dp_pair.py``).

Each model repeats its kernel's design step for step on NumPy arrays, every
window pair of every tile at once, and returns verdict pairs of shape
``(R, n_tiles, 256, 2)`` per pattern (window ``2t + j`` of tile ``i`` of
row ``r`` at ``[r, i, t, j]``), before any ownership:

* band: a tile stages ``kWin + m_max`` text bytes from its first lane
  (zeros past the row); the thread of lanes ``2t, 2t + 1`` keeps both
  windows' cells in the 16-bit halves of one word and advances them with
  the DPX forms (``__viaddmin_u16x2``, ``__vimin3_u16x2``, ``__vminu2``):
  ``v' = min(min(v + (t ^ p), u), u_next, u_prev')``, ``u' = v' + 1`` (a
  plain add, no clamp), the boundary cells of the first ``ke`` steps
  overwritten, the cells clamped at ``k + 2`` every ``kRenorm`` steps, the
  verdict ``v[ke] <= k`` per half; bands wider than ``kRegMax`` take the
  one-window int32 path;
* Myers: the tile's text staged as alphabet channels (the zero column for
  bytes outside the alphabet), the second window's channel carried over
  as the first's at the next step; up to k = 7 both windows packed into
  the 16-bit fields of one bit band (the add's carry kept inside each
  field's spare bits), else each thread's two windows advanced as two
  bit-vector chains.
"""

import numpy as np

from apm_torch.ops import dp_kernel

K_WIN = 512  # windows a tile: 256 threads, two windows each
K_REG_MAX = 16  # widest band half-width in registers
K_RENORM = 1 << 14  # band steps between clamps of the cells
ONE2 = np.uint32(0x00010001)


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


def stage_tiles(rows, wf, m_max):
    """(R, n_tiles, kWin + m_max) staged text (zeros past each row's end)."""
    n_rows, stride = rows.shape
    n_tiles = -(-wf // K_WIN)
    width = K_WIN + m_max
    padded = np.zeros((n_rows, (n_tiles - 1) * K_WIN + width), np.uint8)
    padded[:, : min(stride, padded.shape[1])] = rows[:, : padded.shape[1]]
    return np.stack([padded[:, l : l + width] for l in range(0, n_tiles * K_WIN, K_WIN)], axis=1)


# -- band mode -----------------------------------------------------------------


def _inc(v):
    """``v + 0x00010001``: the halves never carry."""
    assert int(_halves(v)[0].max()) < 0xFFFF and int(_halves(v)[1].max()) < 0xFFFF
    return v + ONE2


def band_pairs(staged, pat_row, m, k, ke, renorm=K_RENORM):
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


def band_wide(staged, pat_row, m, k, ke):
    """The one-window int32 path (bands wider than kRegMax), for each
    window of each pair."""
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


def band_verdicts(rows, pat, *, k, m_max, wf, plens, renorm=K_RENORM):
    """Per-pattern verdict pairs of the band kernels; a length outside
    ``[1, m_max]`` (a padding slot) scans nothing and reads no hit."""
    ke = min(k, m_max)
    staged = stage_tiles(rows, wf, m_max)
    hits = []
    for p, m in enumerate(plens):
        if not 0 < m <= m_max:
            hits.append(np.zeros(staged.shape[:2] + (K_WIN // 2, 2), bool))
        elif ke <= K_REG_MAX:
            hits.append(band_pairs(staged, pat[p], m, k, ke, renorm))
        else:
            hits.append(band_wide(staged, pat[p], m, k, ke))
    return np.stack(hits)


# -- Myers mode ----------------------------------------------------------------


def bit_step(vp, vn, cc, eq, mask, cbit, one=np.uint32(1)):
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


def myers_packed(ch, peq, base, m, k):
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
        st = list(bit_step(*st, eq, mask, x - 1, ONE2))
    if m > k:
        st[0] = ((st[0] << np.uint32(1)) | ONE2) & mask
        st[1] = (st[1] << np.uint32(1)) & mask
        for x in range(k + 1, m + 1):
            st[0] = ((st[0] >> np.uint32(1)) & mask) | top
            st[1] = (st[1] >> np.uint32(1)) & mask
            lo, hi = hi, ch[:, :, even + x]
            eq = peq[base + x - 1][lo] | (peq[base + x - 1][hi] << np.uint32(16))
            st = list(bit_step(*st, eq, mask, k, ONE2))
    cc_lo, cc_hi = _halves(st[2])
    return np.stack([cc_lo <= k, cc_hi <= k], axis=-1)


def myers_verdicts(rows, pat, *, k, m_max, wf, plens, alphabet, packed=None):
    """Per-pattern verdict pairs of the Myers kernels: channels staged once
    a tile, the PEQ table with a zero column, both windows in one word
    where ``packed`` (the kernels' choice, 2k + 1 <= 15, by default), else
    two chains a thread."""
    if packed is None:
        packed = 2 * k + 1 <= 15
    n_chan = len(alphabet)
    peq = dp_kernel.build_peq(pat, k, m_max, alphabet).astype(np.uint32)
    peq = np.concatenate([peq, np.zeros((peq.shape[0], 1), np.uint32)], axis=1)  # (P*m, C + 1)
    lut = np.full(256, n_chan, np.int64)
    lut[list(alphabet)] = np.arange(n_chan)
    staged = stage_tiles(rows, wf, m_max)
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
            hits.append(myers_packed(ch, peq, base, m, k))
            continue
        s = [[np.full(shape, mask, np.uint32), np.zeros(shape, np.uint32), np.zeros(shape, np.uint32)]
             for _ in (0, 1)]
        hi = ch[:, :, even]
        for x in range(1, min(k, m) + 1):  # static band: PEQ row k
            lo, hi = hi, ch[:, :, even + x]
            for st, c in zip(s, (lo, hi)):
                st[:] = bit_step(*st, peq[base + k][c], mask, x - 1)
        if m > k:
            for st in s:
                st[0] = ((st[0] << np.uint32(1)) | np.uint32(1)) & mask
                st[1] = (st[1] << np.uint32(1)) & mask
            for x in range(k + 1, m + 1):
                lo, hi = hi, ch[:, :, even + x]
                for st, c in zip(s, (lo, hi)):
                    st[0] = (st[0] >> np.uint32(1)) | topbit
                    st[1] = st[1] >> np.uint32(1)
                    st[:] = bit_step(*st, peq[base + x - 1][c], mask, k)
        hits.append(np.stack([s[0][2] <= k, s[1][2] <= k], axis=-1))
    return np.stack(hits)
