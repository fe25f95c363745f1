"""Bit-plane correlation engine (port of ``apm/ops/corr_engine.py``).

At k = 0 approximate matching is exact matching. ``apm`` scores it as a
±1 bit-plane correlation: each text byte's code (its rank in the sorted
pattern alphabet) is written as ``B = max(1, ceil(log2 C))`` planes of ±1
(bytes outside the alphabet: all zero), and window ``j`` matches pattern
``p`` iff ``corr[j, p] == B * m_p``. The port keeps the gates and the
table constructors so its plan and tables equal ``apm``'s. At k = 0 the
scan is the fused kernel in :mod:`apm_torch.ops.corr_fused` where ``apm``'s
fused gate takes it, else ``apm``'s conv of whole patterns
(:func:`scan_corr_mxu` for ``count``, :func:`scan_corr_batch` for
``count_batch``; 97 < m_max <= 512, or ``corr_impl="conv"``), which ``apm``
computes in XLA outside any Pallas kernel and the port with ``conv1d``.
The conv runs in float32, never bf16: its scores reach ``B * m`` = 1536 at
m = 512, where bf16 can no longer tell a match from the nearest miss.

Conv phase 1 of filtration (k >= 1, :func:`scan_pieces_conv`) is the same
correlation over exact-tier pieces: a piece hits where its correlation
reaches ``B * length``, and a row is a candidate row of pattern ``p`` when
any piece of ``p`` hits anywhere in it. ``apm`` computes it in XLA outside
any Pallas kernel; the port computes it with ``conv1d`` in float32 (±1
operands and integer sums below 2**24: exact in float32, and in TF32 on
the card).
"""

from __future__ import annotations

import numpy as np
import torch

# Channels beyond this dilute the contraction; larger pattern alphabets go
# to the banded engine.
ALPHABET_MAX = 16

# Conv kernel width cap of apm's XLA correlation engine.
M_MAX_CORR = 512

# "auto" crossover of apm's plan (measured on apm's TPU; the port copies it
# so both packages route alike — re-measuring it on the H100 is open work).
AUTO_MIN_WORK = 256
AUTO_MIN_MMAX = 48

# Minimum piece length for apm's conv phase 1 (k >= 1); part of the plan.
FP1_LMIN = 10

# Target bytes of bf16 bit-plane text per row group (apm's GROUP_BYTES; it
# sizes the groups, so the port's groups equal apm's).
GROUP_BYTES = 64 << 20

# Bound on one conv call's float32 output in scan_pieces_conv: a group
# is scanned in as many row slices as keep (rows, pieces, positions)
# under it.
_CONV_OUT_BYTES = 256 << 20


def build_alphabet(raw_patterns) -> np.ndarray:
    """Sorted distinct bytes across the pattern set, as (C,) uint8."""
    if not raw_patterns:
        return np.zeros((0,), dtype=np.uint8)
    cat = np.concatenate(
        [np.frombuffer(bytes(p), dtype=np.uint8) for p in raw_patterns]
    )
    return np.unique(cat)


def n_bitplanes(alphabet_size: int) -> int:
    """±1 channel count for a C-symbol alphabet: ``max(1, ceil(log2 C))``."""
    return max(1, (max(alphabet_size, 1) - 1).bit_length())


def corr_eligible(
    plens, alphabet_size: int, m_max: int, k: int, auto: bool = False
) -> bool:
    """Gate for the correlation engine (``apm``'s ``corr_eligible``).

    With ``auto=True`` the crossover applies on top of the hard
    requirements: corr takes the scan only when the pattern set is heavy
    (``sum >= AUTO_MIN_WORK``) or long (``m_max >= AUTO_MIN_MMAX``).
    """
    ok = (
        k == 0
        and 0 < alphabet_size <= ALPHABET_MAX
        and 0 < m_max <= M_MAX_CORR
        and any(m > 0 for m in plens)
    )
    if not ok or not auto:
        return ok
    return sum(plens) >= AUTO_MIN_WORK or m_max >= AUTO_MIN_MMAX


def fp1_conv_eligible(plens, k: int, alphabet_size: int) -> bool:
    """True when EVERY filtration pattern can run apm's conv phase 1
    (exact-tier pieces of at least ``FP1_LMIN`` bytes). The port computes
    it only so that its plan equals ``apm``'s."""
    from .filter_kernel import pieces_of_j, tier_of

    if k < 1 or not (0 < alphabet_size <= ALPHABET_MAX):
        return False
    ms = [m for m in plens if m > 0]
    if not ms:
        return False
    for m in ms:
        tier = tier_of(m, k)
        if tier is None or tier[1] != 0:
            return False
        j = tier[0]
        if min(length for _, length in pieces_of_j(m, j)) < FP1_LMIN:
            return False
        if max(length for _, length in pieces_of_j(m, j)) > M_MAX_CORR:
            return False
    return sum(ms) >= AUTO_MIN_WORK or max(ms) >= AUTO_MIN_MMAX


def pick_stride(n0: int) -> int:
    """``apm``'s shift-fold stride for a conv with ``n0`` base channels:
    powers of two up to 32 with ``n0 * S <= 128``, and 1 past 24
    channels. The stride folds ``S`` shifted kernel copies into the
    channel axis (a TPU matrix-unit utilization trick); the port keeps it
    because the stride decides which row positions the conv covers."""
    if n0 > 24:
        return 1
    s = 1
    while s < 32 and n0 * s * 2 <= 128:
        s *= 2
    return s


def _fold_shifts(kern: np.ndarray, thr: np.ndarray, stride: int):
    """Fold ``stride`` shifted copies of a base kernel ``(wk, B, n0)`` into
    the channel axis: channel ``s*n0 + c`` holds base channel ``c`` at
    offset ``s``."""
    if stride == 1:
        return kern, thr
    wk, c, n0 = kern.shape
    ks = np.zeros((wk + stride - 1, c, n0 * stride), dtype=kern.dtype)
    for s in range(stride):
        ks[s : s + wk, :, s * n0 : (s + 1) * n0] = kern
    return ks, np.tile(thr, stride)


def build_kernel(pat_raw: np.ndarray, plens, alphabet: np.ndarray, stride: int = 1):
    """±1 bit-plane conv kernel of whole patterns ``(m_max + stride - 1, B,
    P*stride)`` and thresholds ``(P*stride,)``, both float32 (``apm``'s
    ``build_kernel`` casts the kernel to bf16; ±1/0 are exact in both).
    Position ``i < m_p`` of pattern ``p`` carries the code bits of its byte;
    the threshold is ``B * m_p``, and ``2**30`` (never reached) for padding
    rows. ``stride`` shift-folds the kernel as ``apm``'s strided conv takes
    it (:func:`_fold_shifts`)."""
    P, m_max = pat_raw.shape
    B = n_bitplanes(len(alphabet))
    kern = np.zeros((m_max, B, P), dtype=np.float32)
    thr = np.zeros((P,), dtype=np.float32)
    for pi in range(P):
        m = plens[pi]
        thr[pi] = B * m if m > 0 else np.float32(2**30)
        for i in range(min(m, m_max)):
            ci = int(np.searchsorted(alphabet, pat_raw[pi, i]))
            for b in range(B):
                kern[i, b, pi] = 1.0 if (ci >> b) & 1 else -1.0
    return _fold_shifts(kern, thr, stride)


def _conv_row_counts(rows, kern, thr, alph, limit, *, wf, stride, g_rows):
    """``(R, P)`` int64 exact-match counts per staged row, row ``r`` owning
    lanes ``[0, limit[r])``, by ``apm``'s bit-plane conv.

    ``apm`` runs an ``S``-strided conv against ``S`` shifted kernel copies
    (output block ``jb``, channel ``s*P + p`` is window ``jb*S + s``). The
    port unfolds the strided kernel into its base kernel (channel copy 0,
    the first ``m_max`` rows) and runs one stride-1 ``conv1d``: the same
    scores at 1/S of the multiplies. Both operands are ±1/0 and every sum
    is an integer of magnitude <= B * m_max < 2**24: exact in float32, and
    in TF32, which cuDNN may use for a float32 conv on the card."""
    R, L = rows.shape
    dev = rows.device
    S = stride
    n_base = kern.shape[2] // S
    m_max = kern.shape[0] - S + 1
    weight = kern[:m_max, :, :n_base].to(device=dev, dtype=torch.float32)
    weight = weight.permute(2, 1, 0).contiguous()  # (P, B, m_max)
    thr0 = thr[:n_base].to(device=dev, dtype=torch.float32)
    b_planes = weight.shape[1]
    alph = alph.to(dev)
    col = torch.arange(wf, device=dev, dtype=torch.int64)
    # float32 scores and planes, int64 byte indices, per staged row
    per_row = (4 * (n_base + b_planes) + 8) * L
    step = max(1, min(g_rows, _CONV_OUT_BYTES // per_row))
    counts = torch.zeros((R, n_base), dtype=torch.int64, device=dev)
    for r0 in range(0, R, step):
        t = _encode_planes(rows[r0 : r0 + step], alph, b_planes)  # (g, B, L)
        corr = torch.nn.functional.conv1d(t, weight)[:, :, :wf]  # (g, P, wf)
        own = col[None, :] < limit[r0 : r0 + step, None]  # (g, wf)
        match = (corr >= thr0[None, :, None]) & own[:, None, :]
        counts[r0 : r0 + step] = match.sum(dim=2)
    return counts


def scan_corr_mxu(
    rows: torch.Tensor,
    kern: torch.Tensor,
    thr: torch.Tensor,
    alph: torch.Tensor,
    bound,
    start: int,
    *,
    wf: int,
    m_max: int,
    n_rows: int,
    g_rows: int,
    stride: int = 1,
    p_out: int = 0,
) -> torch.Tensor:
    """``(max(P, p_out),)`` int32 exact-match counts of this chunk's
    device-owned windows (``apm``'s ``scan_corr_mxu``): row ``r`` owns
    windows ``[start + r*wf, start + (r+1)*wf)`` below ``bound``, and rows
    at or past ``n_rows`` own nothing (the mask matters: a pattern that
    holds a NUL byte matches the zero padding). ``kern``/``thr`` are
    :func:`build_kernel`'s tables over the real patterns, on any float
    dtype; ``stride`` is the one they were folded with."""
    R, L = rows.shape
    if wf % stride or kern.shape[0] != m_max + stride - 1 or L < wf + m_max - 1:
        raise ValueError(f"wf {wf}, stride {stride}, kern {tuple(kern.shape)}, rows "
                         f"{tuple(rows.shape)}: need S | wf, m_max + S - 1 kernel rows, "
                         f"halo >= m_max - 1")
    r = torch.arange(R, device=rows.device, dtype=torch.int64)
    limit = torch.where(r < n_rows, (bound - start - r * wf).clamp(0, wf), 0)
    counts = _conv_row_counts(rows, kern, thr, alph, limit, wf=wf, stride=stride,
                              g_rows=g_rows).sum(dim=0)
    out = torch.zeros((max(counts.shape[0], p_out),), dtype=torch.int32, device=rows.device)
    out[: counts.shape[0]] = counts.to(torch.int32)
    return out


def scan_corr_batch(
    rows: torch.Tensor,
    kern: torch.Tensor,
    thr: torch.Tensor,
    alph: torch.Tensor,
    limits: torch.Tensor,
    *,
    wf: int,
    fold: int,
    g_rows: int,
    stride: int = 1,
    p_out: int = 0,
) -> torch.Tensor:
    """Batched k = 0 correlation conv (``apm``'s ``scan_corr_batch``):
    ``(R // fold, max(P, p_out))`` int32 per-block counts, row ``r`` owning
    lanes ``[0, limits[r])`` (precomputed by the caller from each corpus's
    bound; 0 for padding rows)."""
    R, L = rows.shape
    m_max = kern.shape[0] - stride + 1
    if wf % stride or R % fold or L < wf + m_max - 1:
        raise ValueError(f"wf {wf}, stride {stride}, rows {tuple(rows.shape)}, fold {fold}: "
                         f"need S | wf, fold | R, halo >= m_max - 1")
    per_row = _conv_row_counts(rows, kern, thr, alph, limits.to(torch.int64), wf=wf,
                               stride=stride, g_rows=g_rows)
    n_base = per_row.shape[1]
    out = torch.zeros((R // fold, max(n_base, p_out)), dtype=torch.int32, device=rows.device)
    out[:, :n_base] = per_row.reshape(R // fold, fold, n_base).sum(dim=1).to(torch.int32)
    return out


def _group_rows(L: int, C: int, n_rows: int) -> int:
    """Rows per group: ~GROUP_BYTES of bf16 bit-plane text, >= 8, <=
    ``n_rows`` (``apm``'s grouping)."""
    per_row = L * n_bitplanes(C) * 2
    g = max(8, GROUP_BYTES // max(per_row, 1))
    return int(min(g, n_rows))


def plane_table(alph: torch.Tensor, b_planes: int) -> torch.Tensor:
    """``(256, B)`` float32 bit-plane code of every byte value: plane ``b``
    of an alphabet byte is +1 if bit ``b`` of its code (its index in the
    sorted ``alph``) is set, else -1; bytes outside the alphabet are 0."""
    lut = torch.zeros((256, b_planes), dtype=torch.float32, device=alph.device)
    codes = torch.arange(len(alph), device=alph.device)
    bits = (codes[:, None] >> torch.arange(b_planes, device=alph.device)) & 1
    lut[alph.long()] = (2 * bits - 1).to(torch.float32)
    return lut


def _encode_planes(rg: torch.Tensor, alph: torch.Tensor, cbits: int) -> torch.Tensor:
    """±1 bit-plane text encode ``(g, L) uint8 -> (g, cbits, L)`` float32,
    planes first as ``conv1d`` takes them (``apm``'s ``_encode_planes``,
    through a 256-entry table)."""
    return plane_table(alph, cbits)[rg.long()].permute(0, 2, 1)


def build_piece_kernel(pat_raw: np.ndarray, plens, k: int, alphabet, stride: int = 1):
    """Piece-correlation tables for conv phase 1 (``apm``'s, in float32):
    ``(kern (w_kern + stride - 1, B, N*stride), thr (N*stride,),
    owner (N, P))``, N the exact-tier pieces of every pattern, ``thr`` each
    piece's ``B * length``, ``owner`` the piece -> pattern one-hot."""
    from .filter_kernel import pieces_of_j, tier_of

    P, _ = pat_raw.shape
    B = n_bitplanes(len(alphabet))
    pieces = []  # (pattern index, offset, length)
    for pi in range(P):
        m = plens[pi]
        if m == 0:
            continue
        j, kp = tier_of(m, k)
        if kp != 0:
            raise ValueError("conv phase 1 is exact-tier only")
        pieces.extend((pi, off, length) for off, length in pieces_of_j(m, j))
    n = len(pieces)
    w_kern = max(length for _, _, length in pieces)
    kern = np.zeros((w_kern, B, n), dtype=np.float32)
    thr = np.zeros((n,), dtype=np.float32)
    owner = np.zeros((n, P), dtype=np.float32)
    for ni, (pi, off, length) in enumerate(pieces):
        thr[ni] = B * length
        owner[ni, pi] = 1.0
        for i in range(length):
            ci = int(np.searchsorted(alphabet, pat_raw[pi, off + i]))
            for b in range(B):
                kern[i, b, ni] = 1.0 if (ci >> b) & 1 else -1.0
    kern, thr = _fold_shifts(kern, thr, stride)
    return kern, thr, owner


def scan_pieces_conv(
    rows: torch.Tensor,
    kern: torch.Tensor,
    thr: torch.Tensor,
    owner: torch.Tensor,
    alph: torch.Tensor,
    bound,
    start: int,
    *,
    wf: int,
    w_kern: int,
    n_rows: int,
    g_rows: int,
    stride: int = 1,
):
    """Conv phase 1: ``(fcnt (P,) int32, rowmap (R, P) int32)``, ``apm``'s
    contract. ``kern``/``thr`` are :func:`build_piece_kernel`'s tables (on
    the rows' device, any float dtype), ``owner`` its piece -> pattern
    one-hot, ``w_kern`` the full folded kernel width.

    ``fcnt[p]`` counts the hits of ``p``'s pieces over every row that owns
    a valid window (``r < n_rows`` and ``start + r*wf < bound``);
    ``rowmap[r, p]`` is 1 when that count is nonzero in row ``r``. ``apm``
    covers piece positions ``[0, T)`` with ``T = nb * S``, ``nb = (L + S -
    1 - w_kern) // S + 1`` blocks of its ``S``-strided conv over text
    zero-padded by ``S - 1`` bytes. The port unfolds the strided kernel
    into its base piece kernel (channel copy 0) and runs one stride-1
    ``conv1d`` over the same padded text, keeping positions ``[0, T)``:
    the same scores at 1/S of the multiplies.
    """
    R, L = rows.shape
    dev = rows.device
    S = stride
    n_pat = owner.shape[1]
    n0 = kern.shape[2] // S
    w_base = w_kern - S + 1
    base = kern[:w_base, :, :n0].to(torch.float32)  # (w_base, B, n0)
    weight = base.permute(2, 1, 0).contiguous()  # (n0, B, w_base)
    thr0 = thr[:n0].to(torch.float32)
    piece_owner = owner.argmax(dim=1).to(dev)  # (n0,) pattern of each piece
    b_planes = base.shape[1]
    alph = alph.to(dev)
    T = ((L + S - 1 - w_kern) // S + 1) * S
    # float32 scores and planes, int64 byte indices, per staged row
    per_row = (4 * (n0 + b_planes) + 8) * (L + S)
    step = max(1, min(g_rows, _CONV_OUT_BYTES // per_row))
    rowpat = torch.zeros((R, n_pat), dtype=torch.int64, device=dev)
    for r0 in range(0, R, step):
        rg = rows[r0 : r0 + step]
        if S > 1:
            rg = torch.nn.functional.pad(rg, (0, S - 1))
        t = _encode_planes(rg, alph, b_planes)  # (g, B, L + S - 1)
        corr = torch.nn.functional.conv1d(t, weight)[:, :, :T]  # (g, n0, T)
        hits = (corr >= thr0[None, :, None]).sum(dim=2)  # (g, n0)
        rowpat[r0 : r0 + step].index_add_(1, piece_owner, hits)
    r_abs = torch.arange(R, device=dev, dtype=torch.int64)
    live = (r_abs < n_rows) & (start + r_abs * wf < bound)
    rowpat *= live[:, None]
    fcnt = rowpat.sum(dim=0).to(torch.int32)
    return fcnt, (rowpat > 0).to(torch.int32)
