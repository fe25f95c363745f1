"""Plain reference of the reference C program's counts, in plain PyTorch.

The semantics (the INF560 reference, ``sequential.c:104-144`` with the
square Levenshtein DP of ``utils.c:76-99``): for each pattern ``P`` of
length ``m`` and each window start ``j`` with ``0 <= j < n - k``, the
window is ``L = min(m, n - j)`` bytes; it matches when the Levenshtein
distance between ``P[:L]`` and ``text[j:j + L]`` is at most ``k``. Near the
end of the text the window is truncated (``L < m``, "EOF-truncated").

Each distance is the global edit distance of two ``L``-byte strings,
``D[L][L]`` of the full ``(m + 1) x (m + 1)`` table, computed for many
windows at once by Hyyro's global form of Myers' bit-vector recurrence on
int64 words (``m <= 62``). Full windows are either all taken (short
pieces) or narrowed by the pigeonhole rule first: when ``D <= k``, one of
``k + 1`` disjoint pieces of ``P`` occurs unchanged in the window, shifted
by at most ``k``; every window near a piece's exact occurrence is then
verified by the same recurrence. Nothing here comes from the program
under test.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

M_MAX = 62  # pattern bits in an int64 word, with room for the carry
MIN_PIECE = 6  # shorter pieces hit too often: take every window instead
BLOCK = 1 << 25  # windows per pass of the recurrence

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_H01 = 0x0101010101010101


def _i64(x: int) -> int:
    """``x`` as a signed 64-bit constant."""
    return x - (1 << 64) if x >= 1 << 63 else x


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (x * _i64(_H01)) >> 56


def _peq(pattern: bytes, device) -> torch.Tensor:
    """(256,) int64: bit ``i`` of entry ``c`` is set where ``pattern[i] == c``."""
    table = [0] * 256
    for i, c in enumerate(pattern):
        table[c] |= 1 << i
    return torch.tensor(table, dtype=torch.int64, device=device)


def distances(text: torch.Tensor, starts, lengths: torch.Tensor,
              pattern: bytes) -> torch.Tensor:
    """Edit distance between ``pattern[:L]`` and ``text[j:j + L]`` for each
    start ``j`` and length ``L`` (``1 <= L <= len(pattern)``). ``starts`` is
    a tensor of starts, or an int: the first of ``lengths.numel()``
    consecutive starts. ``text`` is a uint8 tensor holding at least
    ``len(pattern)`` bytes past every start."""
    m = len(pattern)
    if m > M_MAX:
        raise ValueError(f"the reference takes patterns of up to {M_MAX} bytes, got {m}")
    peq = _peq(pattern, text.device)
    mask = (1 << m) - 1
    nw = lengths.numel()
    pv = torch.full((nw,), mask, dtype=torch.int64, device=text.device)
    mv = torch.zeros_like(pv)
    out = torch.zeros_like(pv)
    one_length = bool((lengths == m).all())
    if isinstance(starts, int):  # consecutive windows: one gather for all steps
        eq_all = peq[text[starts: starts + nw + m - 1].long()]
    for y in range(1, m + 1):
        if isinstance(starts, int):
            eq = eq_all[y - 1: y - 1 + nw]
        else:
            eq = peq[text[starts + (y - 1)].long()]
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        ph = (ph << 1) | 1  # row 0 of a global table: D[0][y] = y
        mh = mh << 1
        pv = (mh | ~(xv | ph)) & mask
        mv = ph & xv & mask
        if not one_length:
            at = lengths == y
            if bool(at.any()):
                low = (1 << y) - 1
                out[at] = y + popcount(pv[at] & low) - popcount(mv[at] & low)
    if one_length:
        out = m + popcount(pv) - popcount(mv)
    return out


def _codes(patterns: Sequence[bytes]):
    """Byte -> code table (0 for bytes in no pattern) and bits per code."""
    alphabet = sorted(set(b"".join(patterns)))
    lut = [0] * 256
    for i, c in enumerate(alphabet):
        lut[c] = i + 1
    return lut, max(1, len(alphabet).bit_length())


def _piece_hits(text: torch.Tensor, lut: List[int], bits: int,
                pieces: Sequence[bytes]) -> List[torch.Tensor]:
    """Start positions in ``text`` of each piece's first ``63 // bits``
    bytes (a superset of the piece's exact occurrences)."""
    q = min(max(len(p) for p in pieces), 63 // bits)
    n = text.numel()
    hits: List[List[torch.Tensor]] = [[] for _ in pieces]
    keys = []
    for p in pieces:
        qp = min(len(p), q)
        key = 0
        for s, c in enumerate(p[:qp]):
            key |= lut[c] << (bits * s)
        keys.append((key, (1 << (bits * qp)) - 1))
    lut_t = torch.tensor(lut, dtype=torch.int64, device=text.device)
    for a in range(0, n, BLOCK):
        b = min(n, a + BLOCK)
        code = lut_t[text[a: min(n, b + q)].long()]
        code = torch.nn.functional.pad(code, (0, b + q - a - code.numel()))
        word = torch.zeros(b - a, dtype=torch.int64, device=text.device)
        for s in range(q):
            word |= code[s: s + b - a] << (bits * s)
        for i, (key, kmask) in enumerate(keys):
            hits[i].append(torch.nonzero((word & kmask) == key).flatten() + a)
    return [torch.cat(h) for h in hits]


def count_many(texts: Sequence[np.ndarray], patterns: Sequence[bytes], k: int,
               device, eof: bool = True) -> np.ndarray:
    """``(len(texts), len(patterns))`` int64 counts. ``eof=False`` leaves
    out the EOF-truncated windows (the control: it breaks the stated
    guarantee that they count)."""
    dev = torch.device(device)
    patterns = [bytes(p) for p in patterns]
    out = np.zeros((len(texts), len(patterns)), dtype=np.int64)
    if not texts or not patterns:
        return out
    m_max = max(len(p) for p in patterns)
    lens = np.array([len(t) for t in texts], dtype=np.int64)
    # texts laid end to end, each followed by m_max zero bytes (a code no
    # piece has, and room for the recurrence to read past a truncated end)
    base = np.zeros(len(texts) + 1, dtype=np.int64)
    base[1:] = np.cumsum(lens + m_max)
    host = np.zeros(int(base[-1]), dtype=np.uint8)
    for t, at in zip(texts, base[:-1]):
        host[at: at + len(t)] = t
    text = torch.from_numpy(host).to(dev)
    base_t = torch.from_numpy(base[:-1]).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    lut, bits = _codes(patterns)
    for pi, p in enumerate(patterns):
        out[:, pi] = _count_pattern(text, base, lens, base_t, lens_t, lut, bits, p, k, eof)
    return out


def _count_pattern(text, base, lens, base_t, lens_t, lut, bits, p: bytes, k: int,
                   eof: bool) -> np.ndarray:
    dev = text.device
    m = len(p)
    counts = np.zeros(len(lens), dtype=np.int64)
    if k >= m:  # every window is full and within k: j < n - k <= n - m
        return np.maximum(lens - k, 0)
    # full windows: starts j <= n - m of each text
    if m // (k + 1) >= MIN_PIECE:
        sizes = [m // (k + 1) + (1 if i < m % (k + 1) else 0) for i in range(k + 1)]
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
        pieces = [p[o: o + s] for o, s in zip(offs, sizes)]
        shifts = torch.arange(-k, k + 1, device=dev)
        cand = [(h[:, None] - o + shifts[None, :]).flatten()
                for h, o in zip(_piece_hits(text, lut, bits, pieces), offs)]
        starts = torch.unique(torch.cat(cand))
        owner = torch.searchsorted(base_t, starts, right=True) - 1
        ok = (owner >= 0) & (starts >= base_t[owner.clamp(min=0)])
        ok &= starts <= base_t[owner.clamp(min=0)] + lens_t[owner.clamp(min=0)] - m
        starts, owner = starts[ok], owner[ok]
        for a in range(0, starts.numel(), BLOCK):
            d = distances(text, starts[a: a + BLOCK],
                          torch.full((min(BLOCK, starts.numel() - a),), m, device=dev), p)
            hit = owner[a: a + BLOCK][d <= k]
            counts += torch.bincount(hit, minlength=len(lens)).cpu().numpy()
    else:
        for t in range(len(lens)):
            n_full = int(lens[t]) - m + 1
            for a in range(0, max(n_full, 0), BLOCK):
                nb = min(BLOCK, n_full - a)
                d = distances(text, int(base[t]) + a, torch.full((nb,), m, device=dev), p)
                counts[t] += int((d <= k).sum())
    if eof:
        # truncated windows: n - m < j < n - k, L = n - j in (k, m)
        starts, owner, sizes = [], [], []
        for t, n in enumerate(lens.tolist()):
            j0 = max(0, n - m + 1)
            js = np.arange(j0, max(j0, n - k))
            starts.append(js + int(base[t]))
            owner.append(np.full(len(js), t))
            sizes.append(n - js)
        starts = torch.from_numpy(np.concatenate(starts)).to(dev)
        if starts.numel():
            sizes_t = torch.from_numpy(np.concatenate(sizes)).to(dev)
            d = distances(text, starts, sizes_t, p)
            hit = torch.from_numpy(np.concatenate(owner)).to(dev)[d <= k]
            counts += torch.bincount(hit, minlength=len(lens)).cpu().numpy()
    return counts
