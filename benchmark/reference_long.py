"""Plain reference of the reference C program's counts for patterns of up to
128 bytes, in plain PyTorch.

The semantics are ``reference.py``'s (the INF560 reference,
``sequential.c:104-144``, with the square Levenshtein DP of
``utils.c:76-99``): for each pattern ``P`` of length ``m`` and each window
start ``j`` with ``0 <= j < n - k``, the window is ``L = min(m, n - j)``
bytes, and it matches when the edit distance between ``P[:L]`` and
``text[j:j + L]`` is at most ``k``; windows with ``L < m`` are
EOF-truncated.

``reference.py`` holds its bit vectors in one int64 word, so it stops at 62
bytes. Here they span two words: Hyyro's global form of Myers' recurrence
with the addition's carry and each shift's top bit passed from the low word
to the high one. Full windows are narrowed by the pigeonhole rule as there
(when ``D <= k``, one of ``k + 1`` disjoint pieces of ``P`` occurs unchanged
in the window, shifted by at most ``k``), but the pieces of every pattern
are found in one pass over the text, and the candidate windows of all
patterns of one length are verified together. Nothing here comes from the
program under test, and nothing multiplies matrices.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from benchmark.reference import BLOCK, MIN_PIECE, _codes, _i64, popcount

M_MAX = 128  # two int64 words of pattern bits
WORD = 64


def _masks(m: int) -> List[int]:
    """Per word, the bits of an ``m``-bit vector, as signed constants."""
    return [_i64((1 << min(WORD, m - WORD * w)) - 1) for w in range(-(-m // WORD))]


def _peq(patterns: Sequence[bytes], device) -> torch.Tensor:
    """``(len(patterns) * 256, words)`` int64: row ``i * 256 + c`` holds the
    bits ``b`` where ``patterns[i][b] == c``, low word first."""
    m = len(patterns[0])
    words = -(-m // WORD)
    table = np.zeros((len(patterns), 256, words), dtype=np.uint64)
    for i, p in enumerate(patterns):
        for b, c in enumerate(p):
            table[i, c, b // WORD] |= np.uint64(1 << (b % WORD))
    return torch.from_numpy(table.view(np.int64).reshape(-1, words)).to(device)


def _shl1(x: List[torch.Tensor], low_bit: int) -> List[torch.Tensor]:
    """A multi-word vector shifted up one bit, ``low_bit`` shifted in."""
    out = [(x[0] << 1) | low_bit]
    for w in range(1, len(x)):
        out.append((x[w] << 1) | ((x[w - 1] >> (WORD - 1)) & 1))
    return out


def _add(a: List[torch.Tensor], b: List[torch.Tensor]) -> List[torch.Tensor]:
    """``a + b`` over multi-word vectors: each word's carry out of its top
    bit goes into the next word."""
    out, carry = [], 0
    for x, y in zip(a, b):
        s = x + y + carry
        carry = (((x & y) | ((x | y) & ~s)) >> (WORD - 1)) & 1
        out.append(s)
    return out


def group_distances(text: torch.Tensor, starts, lengths: torch.Tensor,
                    patterns: Sequence[bytes], which=None) -> torch.Tensor:
    """Edit distance between ``P[:L]`` and ``text[j:j + L]`` for each start
    ``j`` and length ``L`` (``1 <= L <= m``), ``P`` the window's pattern:
    ``patterns[which[i]]`` (all of one length ``m <= M_MAX``), or the only
    one where ``which`` is None. ``starts`` is a tensor of starts, or an
    int: the first of ``lengths.numel()`` consecutive starts. ``text`` is a
    uint8 tensor holding at least ``m`` bytes past every start."""
    m = len(patterns[0])
    if not 1 <= m <= M_MAX or any(len(p) != m for p in patterns):
        raise ValueError(f"one pattern length in [1, {M_MAX}] a group, got "
                         f"{sorted({len(p) for p in patterns})}")
    dev = text.device
    peq = _peq(patterns, dev)
    masks = _masks(m)
    words = len(masks)
    nw = lengths.numel()
    row = 0 if which is None else which.long() * 256
    pv = [torch.full((nw,), mk, dtype=torch.int64, device=dev) for mk in masks]
    mv = [torch.zeros((nw,), dtype=torch.int64, device=dev) for _ in masks]
    out = torch.zeros((nw,), dtype=torch.int64, device=dev)
    one_length = bool((lengths == m).all())
    if isinstance(starts, int):  # consecutive windows: one gather for all steps
        eq_all = peq[text[starts: starts + nw + m - 1].long()]
    for y in range(1, m + 1):
        if isinstance(starts, int):
            eq = eq_all[y - 1: y - 1 + nw]
        else:
            eq = peq[row + text[starts + (y - 1)].long()]
        eq = [eq[:, w] for w in range(words)]
        xv = [e | v for e, v in zip(eq, mv)]
        total = _add([e & p for e, p in zip(eq, pv)], pv)
        xh = [(t ^ p) | e for t, p, e in zip(total, pv, eq)]
        ph = _shl1([v | ~(h | p) for v, h, p in zip(mv, xh, pv)], 1)  # D[0][y] = y
        mh = _shl1([p & h for p, h in zip(pv, xh)], 0)
        pv = [(a | ~(x | b)) & mk for a, x, b, mk in zip(mh, xv, ph, masks)]
        mv = [b & x & mk for b, x, mk in zip(ph, xv, masks)]
        if not one_length:
            at = lengths == y
            if bool(at.any()):
                score = torch.full((int(at.sum()),), y, dtype=torch.int64, device=dev)
                for p, v, low in zip(pv, mv, _masks(y)):
                    score += popcount(p[at] & low) - popcount(v[at] & low)
                out[at] = score
    if one_length:
        out = m + sum(popcount(p) - popcount(v) for p, v in zip(pv, mv))
    return out


def distances(text: torch.Tensor, starts, lengths: torch.Tensor, pattern: bytes) -> torch.Tensor:
    """:func:`group_distances` of one pattern: ``reference.distances``'s
    contract, for patterns of up to ``M_MAX`` bytes."""
    return group_distances(text, starts, lengths, [pattern])


def _pieces(m: int, k: int):
    """The pigeonhole's ``k + 1`` pieces of an ``m``-byte pattern, as
    ``(offset, length)``, the longer first."""
    sizes = [m // (k + 1) + (1 if i < m % (k + 1) else 0) for i in range(k + 1)]
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    return list(zip(offs, sizes))


def _key_hits(text: torch.Tensor, lut: List[int], bits: int, q: int, keys: np.ndarray):
    """Starts in ``text`` whose first ``q`` bytes' codes equal one of the
    distinct ``keys``: ``(starts, key index)``, sorted by key index."""
    n = text.numel()
    dev = text.device
    ukeys = torch.from_numpy(keys).to(dev)
    lut_t = torch.tensor(lut, dtype=torch.int64, device=dev)
    starts, kid = [], []
    for a in range(0, n, BLOCK):
        b = min(n, a + BLOCK)
        code = lut_t[text[a: min(n, b + q)].long()]
        code = torch.nn.functional.pad(code, (0, b + q - a - code.numel()))
        word = torch.zeros(b - a, dtype=torch.int64, device=dev)
        for s in range(q):
            word |= code[s: s + b - a] << (bits * s)
        del code
        idx = torch.searchsorted(ukeys, word).clamp(max=len(keys) - 1)
        at = torch.nonzero(ukeys[idx] == word).flatten()
        starts.append(at + a)
        kid.append(idx[at])
    kid = torch.cat(kid)
    order = torch.argsort(kid, stable=True)
    return torch.cat(starts)[order], kid[order]


def _full_counts(text, base_t, lens_t, lut, bits, patterns: Sequence[bytes], k: int) -> torch.Tensor:
    """``(len(patterns), texts)`` counts of the full windows (``j <= n - m``)
    of patterns of one length ``m`` with ``m // (k + 1) >= MIN_PIECE``."""
    dev = text.device
    m = len(patterns[0])
    pieces = _pieces(m, k)
    q = min(min(size for _, size in pieces), 63 // bits)
    key = np.zeros((len(patterns), len(pieces)), dtype=np.int64)
    for i, p in enumerate(patterns):
        for j, (o, _) in enumerate(pieces):
            key[i, j] = sum(lut[c] << (bits * s) for s, c in enumerate(p[o: o + q]))
    keys = np.unique(key)
    at, kid = _key_hits(text, lut, bits, q, keys)
    bounds = torch.searchsorted(kid, torch.arange(len(keys) + 1, device=dev))
    shifts = torch.arange(-k, k + 1, device=dev)
    span = text.numel() + 1
    cand = []
    for i in range(len(patterns)):
        for j, (o, _) in enumerate(pieces):
            u = int(np.searchsorted(keys, key[i, j]))
            c = (at[bounds[u]: bounds[u + 1], None] - o + shifts[None, :]).flatten()
            cand.append(i * span + c[(c >= 0) & (c < span)])
    cand = torch.unique(torch.cat(cand))
    which, starts = cand // span, cand % span
    owner = torch.searchsorted(base_t, starts, right=True) - 1
    ok = owner >= 0
    owner = owner.clamp(min=0)
    ok &= (starts >= base_t[owner]) & (starts <= base_t[owner] + lens_t[owner] - m)
    which, starts, owner = which[ok], starts[ok], owner[ok]
    n_texts = lens_t.numel()
    counts = torch.zeros(len(patterns) * n_texts, dtype=torch.int64, device=dev)
    for a in range(0, starts.numel(), BLOCK):
        sl = slice(a, a + BLOCK)
        d = group_distances(text, starts[sl], torch.full_like(starts[sl], m), patterns,
                            which[sl])
        hit = d <= k
        counts += torch.bincount(which[sl][hit] * n_texts + owner[sl][hit],
                                 minlength=counts.numel())
    return counts.reshape(len(patterns), n_texts)


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
    if max(len(p) for p in patterns) > M_MAX:
        raise ValueError(f"the reference takes patterns of up to {M_MAX} bytes")
    m_max = max(len(p) for p in patterns)
    lens = np.array([len(t) for t in texts], dtype=np.int64)
    # texts laid end to end, each followed by m_max zero bytes (room for
    # the recurrence to read past a truncated end)
    base = np.zeros(len(texts) + 1, dtype=np.int64)
    base[1:] = np.cumsum(lens + m_max)
    host = np.zeros(int(base[-1]), dtype=np.uint8)
    for t, at in zip(texts, base[:-1]):
        host[at: at + len(t)] = t
    text = torch.from_numpy(host).to(dev)
    base_t = torch.from_numpy(base[:-1]).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    lut, bits = _codes(patterns)

    by_length = {}
    for i, p in enumerate(patterns):
        by_length.setdefault(len(p), []).append(i)
    for m, group in sorted(by_length.items()):
        pats = [patterns[i] for i in group]
        if k >= m:  # every window is full and within k: j < n - k <= n - m
            out[:, group] = np.maximum(lens - k, 0)[:, None]
            continue
        # full windows: starts j <= n - m of each text
        if m // (k + 1) >= MIN_PIECE:
            out[:, group] += _full_counts(text, base_t, lens_t, lut, bits, pats, k).T.cpu().numpy()
        else:
            for gi, p in zip(group, pats):
                for t in range(len(lens)):
                    n_full = int(lens[t]) - m + 1
                    for a in range(0, max(n_full, 0), BLOCK):
                        nb = min(BLOCK, n_full - a)
                        d = distances(text, int(base[t]) + a,
                                      torch.full((nb,), m, device=dev), p)
                        out[t, gi] += int((d <= k).sum())
        if eof:
            out[:, group] += _truncated_counts(text, base, lens, pats, k).T
    return out


def _truncated_counts(text, base, lens, patterns: Sequence[bytes], k: int) -> np.ndarray:
    """``(len(patterns), texts)`` counts of the EOF-truncated windows, ``n -
    m < j < n - k`` with ``L = n - j`` in ``(k, m)``, of patterns of one
    length ``m``."""
    dev = text.device
    m, g = len(patterns[0]), len(patterns)
    starts, owner, sizes = [], [], []
    for t, n in enumerate(lens.tolist()):
        j0 = max(0, n - m + 1)
        js = np.arange(j0, max(j0, n - k))
        starts.append(js + int(base[t]))
        owner.append(np.full(len(js), t))
        sizes.append(n - js)
    starts, owner, sizes = (np.tile(np.concatenate(x), g) for x in (starts, owner, sizes))
    counts = np.zeros((g, len(lens)), dtype=np.int64)
    if not len(starts):
        return counts
    which = np.repeat(np.arange(g), len(starts) // g)
    d = group_distances(text, torch.from_numpy(starts).to(dev), torch.from_numpy(sizes).to(dev),
                        patterns, torch.from_numpy(which).to(dev)).cpu().numpy()
    np.add.at(counts, (which[d <= k], owner[d <= k]), 1)
    return counts
