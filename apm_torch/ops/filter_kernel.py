"""Pigeonhole filtration, phase 1: kernel D and its plain PyTorch version,
with the host half of ``apm/ops/filter_kernel.py``.

Tiers (Navarro's pigeonhole taxonomy): split a pattern of length ``m`` into
``j`` pieces; a window within edit distance ``k`` has some piece matching
with at most ``floor(k / j)`` errors. The exact tier uses ``j = k + 1``
pieces with 0 errors, the banded tier ``j = k//2 + 1`` pieces with 1 error.
:func:`tier_of` and :func:`partition_plens` decide, exactly as ``apm`` does,
which patterns filtration takes.

Scan contract (``apm``'s ``scan_filter_pallas``), shared by
:func:`scan_filter` and :func:`scan_filter_ref`: staged rows
``(R, wf + halo)`` uint8 with ``halo >= m_max + 2k``, the raw pattern table
``(P, m_max)`` uint8 and static lengths (each 0 or filtration-eligible).
Piece ``(o, li)`` of a pattern carries a pinned-start band of ``2kp + 1``
cells; it hits at text position ``T`` when the band, run over the text
from ``T``, reaches ``<= kp`` at one of its end drifts. Window ``j`` of row
``r`` (``j = start + r*wf + lane``) is a candidate of pattern ``p`` iff
``j < bound`` and some piece hits at ``lane + o + s`` for a shift ``s`` in
:func:`piece_shift_range`. Returns ``(fcnt (P,), rowmap (R, P))`` int32:
candidate totals (exact match counts at k = 0) and candidate windows per
row. Phase 2 (:mod:`apm_torch.ops.fused`) verifies candidate rows.

:func:`scan_filter` launches kernel D (``csrc/filter_pieces.cu``) for a
CUDA tensor and uses :func:`scan_filter_ref` only for a CPU tensor. The
kernel tests each piece's head word at every position a window reaches,
reads the rest of the piece (exact tier) or runs the band (banded tier,
after a necessary half-split word test) only where that passes, and ORs
the hits over the shift span. The host sends each piece's layout
(:func:`piece_layout`); the kernel builds the head and tail words from the
char table. On the card the rows' pointer and row stride must be multiples
of 4 bytes (``corr_fused.check_aligned_rows``), as the Scanner's staging
gives them.

A thread of kernel D owns the 32 windows of one tile of one row. Its unit
of work, the item, is a group of whole rows where a row's tiles fill less
than half a block (64 rows of 4 tiles at ``wf`` = 128, so every thread
owns windows), else a segment of one row; each row of an item is staged
in its own slot of the shared buffer, its tiles and its halo, at a length
that keeps a warp's lanes on different banks. The lanes of a warp that
share a row sum their counts before one atomic adds them to ``rowmap``.
:func:`item_rows` makes that choice from ``wf``, the halo, the launch
group's pieces and patterns and the device's shared memory, and the entry
takes it as it is; the entry sizes the grid from the device's residency
for that block.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

FOLD = 8  # apm's fold-8 int32 layout; make_plan rounds block widths to it
INF = 1 << 20  # additive-safe infinity for out-of-band piece-DP cells
K_MAX = 16  # filtration eligibility cap (both tiers)
SENTINEL = 256  # pattern-table padding no widened text byte equals

# Minimum piece length per tier (selectivity bound; see apm's module doc).
EXACT_LMIN_HIGH = 14  # exact tier, k >= 5
BANDED_LMIN = {5: 14, 6: 14, 7: 14, 8: 14}  # else 16 for k in [9, 16]

# Kernel launches made by scan_filter.
LAUNCHES = 0

# Columns of a piece_layout row: off (= o + s_lo), span (= s_hi - s_lo), li,
# kp, o, tail_off, n_head, n_tail.
PIECE_COLS = 8
# Launch groups of kernel D: a block holds a group's piece table (64 bytes a
# piece with its words) and counters (16 bytes a pattern) in shared memory,
# beside three staging buffers of the text (about 29 KB at 256 threads and
# a 128-byte halo), within the 227 KB a block may take.
_PAT_GROUP = 2048
_PIECE_GROUP = 1024
# Kernel D's block (csrc/filter_pieces.cu): threads of 32-window tiles, at
# most _MAX_THREADS; three staging buffers and a pad after the last slot.
_TILE = 32
_MAX_THREADS = 256
_STAGES = 3
_REACH_PAD = 128
# Dynamic shared memory a block of an H100 may opt in to (227 KB): the
# device's own value where kernel D launches (smem_optin).
SMEM_OPTIN = 232_448


def pieces_of_j(m: int, j: int):
    """Static piece table: [(offset, length)] — j contiguous pieces."""
    l = m // j
    return [(i * l, l if i < j - 1 else m - (j - 1) * l) for i in range(j)]


def pieces_of(m: int, k: int):
    """Exact-tier piece table (k + 1 pieces)."""
    return pieces_of_j(m, k + 1)


def banded_j(k: int) -> int:
    """Piece count of the banded tier: the fewest pieces with k//j == 1."""
    return k // 2 + 1


def tier_of(m: int, k: int):
    """Filtration plan for one pattern: ``(j, kp)`` or None (banded DP).

    Exact pieces are preferred (cheaper and more selective); the banded
    tier extends coverage to mid-length patterns at k in [5, 16].
    """
    if m < 1:
        return None
    if k == 0:
        return (1, 0)
    if k <= 4:
        return (k + 1, 0) if m // (k + 1) >= max(k, 8) else None
    if k <= K_MAX:
        if m // (k + 1) >= EXACT_LMIN_HIGH:
            return (k + 1, 0)
        j = banded_j(k)
        if m // j >= BANDED_LMIN.get(k, 16):
            return (j, 1)
    return None


def filter_eligible(m: int, k: int) -> bool:
    """True when some filtration tier applies to an (m, k) pattern."""
    return tier_of(m, k) is not None


def shift_range(o: int, li: int, m: int, k: int):
    """Geometric occurrence shifts for a *middle* piece at [o, o+li)."""
    return (-min(o, k), min(k, m - o - li))


def piece_shift_range(idx: int, j: int, o: int, li: int, m: int, k: int, kp: int):
    """Allowed occurrence shifts for piece ``idx`` of ``j``.

    The equal-length-window alignment pins the first piece's start at the
    window start and the last piece's end at the window end; middle pieces
    drift by the errors spent before/after them (<= k), clamped to fit.
    """
    if idx == 0:
        return (0, 0)
    if idx == j - 1:
        return (-min(o, kp), min(kp, m - o - li + kp))
    return (-min(o, k), min(k, m - o - li + kp))


def partition_plens(plens: tuple, k: int, engine: str):
    """Split a static length tuple into (fmask, filtration, banded-DP)."""
    use = engine in ("auto", "filter")
    fmask = tuple(use and m > 0 and filter_eligible(m, k) for m in plens)
    plens_filter = tuple(m if f else 0 for m, f in zip(plens, fmask))
    plens_dp = tuple(0 if f else m for m, f in zip(plens, fmask))
    return fmask, plens_filter, plens_dp


def sentinel_pad(plens, k: int) -> int:
    """Front sentinel columns of the char table: the largest piece ``kp``."""
    return max((tier_of(m, k)[1] for m in plens if m > 0), default=0)


def pchar_table(pat_raw: torch.Tensor, pad: int) -> torch.Tensor:
    """The int32 pattern-char table both scans read: ``pat_raw`` widened,
    with ``pad`` sentinel columns in front and ``2*pad`` behind when
    ``pad > 0`` (``apm``'s ``scan_filter_pallas``, ``:383-396``).

    Out-of-piece compares hit the sentinel 256, which no text byte
    equals. The front needs ``pad`` columns (index ``x - 1 + d + pad >=
    o - kp + pad >= 0``); the back ``2*pad``: the final capture step of
    the last piece reads up to index ``m - 1 + 2kp + pad``.
    """
    if not pad:
        return pat_raw.to(torch.int32)
    p, m_max = pat_raw.shape
    t = torch.full((p, m_max + 3 * pad), SENTINEL, dtype=torch.int32, device=pat_raw.device)
    t[:, pad : pad + m_max] = pat_raw.to(torch.int32)
    return t


def piece_plan(plens, k: int):
    """Kernel D's piece table: ``(pieces (N, 5) int32 rows (o, li, kp,
    s_lo, s_hi) grouped by pattern, pstart (P + 1,) int32 range of each
    pattern, largest shift span)``."""
    rows, pstart = [], [0]
    for m in plens:
        if m > 0:
            j, kp = tier_of(m, k)
            for idx, (o, li) in enumerate(pieces_of_j(m, j)):
                s_lo, s_hi = piece_shift_range(idx, j, o, li, m, k, kp)
                rows.append((o, li, kp, s_lo, s_hi))
        pstart.append(len(rows))
    pieces = np.asarray(rows, dtype=np.int32).reshape(-1, 5)
    span = int((pieces[:, 4] - pieces[:, 3]).max()) if len(rows) else 0
    return pieces, np.asarray(pstart, dtype=np.int32), span


@functools.lru_cache(maxsize=64)
def piece_layout(plens: tuple, k: int):
    """Kernel D's piece table: ``(table (N, PIECE_COLS) int32, pstart
    (P + 1,) int32)``, pieces grouped by pattern as in :func:`piece_plan`.
    Cached; both arrays are read-only.

    Row ``q`` holds the piece's first tested position ``off = o + s_lo``
    (window ``w`` tests positions ``w + off .. w + off + span``), ``span =
    s_hi - s_lo``, ``li``, ``kp``, ``o``, ``tail_off``, ``n_head`` and
    ``n_tail``. The kernel's head word is the piece's first ``n_head =
    min(li, 8)`` bytes (exact tier) or ``min(8, li // 2)`` (banded tier);
    its tail word (banded tier only) the last ``n_tail = min(8, ceil(li /
    2))``, tested at ``T + tail_off + 1 + d`` for a head at ``T``,
    ``tail_off = li - n_tail - 1``, ``d`` in {-1, 0, 1}. Both are packed in
    :func:`corr_fused.prefix_words`' byte order.
    """
    pieces, pstart, _ = piece_plan(plens, k)
    table = np.zeros((len(pieces), PIECE_COLS), np.int32)
    for i, (o, li, kp, s_lo, s_hi) in enumerate(pieces.tolist()):
        n_head = min(li, 8) if kp == 0 else min(8, li // 2)
        n_tail = 0 if kp == 0 else min(8, (li + 1) // 2)
        tail_off = li - n_tail - 1 if kp else 0
        table[i] = (o + s_lo, s_hi - s_lo, li, kp, o, tail_off, n_head, n_tail)
    table.setflags(write=False)
    pstart.setflags(write=False)
    return table, pstart


@functools.lru_cache(maxsize=64)
def _device_layout(plens: tuple, k: int, dev: torch.device):
    """:func:`piece_layout`'s ``(table, pstart)`` on ``dev``, copied once
    per ``(plens, k, device)``: a launch sends no host-to-device copy of
    its own, which would hold the host until the stream drained."""
    table, pstart = piece_layout(plens, k)
    return torch.tensor(table, device=dev), torch.tensor(pstart, device=dev)


def launch_groups(pstart: np.ndarray) -> tuple:
    """Kernel D's launch groups ``(p0, p1)``: consecutive patterns, at most
    ``_PAT_GROUP`` of them and ``_PIECE_GROUP`` pieces, each holding a
    piece."""
    groups, p0, n_pat = [], 0, len(pstart) - 1
    while p0 < n_pat:
        p1 = p0 + 1
        while (p1 < n_pat and p1 - p0 < _PAT_GROUP
               and pstart[p1 + 1] - pstart[p0] <= _PIECE_GROUP):
            p1 += 1
        if pstart[p1] > pstart[p0]:
            groups.append((p0, p1))
        p0 = p1
    return tuple(groups)


class Items(NamedTuple):
    """Kernel D's unit of work and block: ``rows`` whole staged rows an item
    (1: a segment of one row, ``threads`` tiles long), ``threads`` a block,
    ``slot`` staged bytes a row."""

    rows: int
    threads: int
    slot: int


def block_smem(items: Items, n_piece: int, n_pat: int) -> int:
    """Dynamic shared memory of kernel D's block (``block_smem`` in
    ``csrc/filter_pieces.cu``): 64 bytes a piece, the pattern ranges and
    totals, and three staging buffers of ``items.rows`` slots and the pad,
    with a 4-byte gap after every 32 bytes."""
    words = (items.rows * items.slot + _REACH_PAD) // 4
    return 64 * n_piece + 4 * (2 * n_pat + 1) + 4 * _STAGES * (words + words // 8)


def _slot(tiles: int, rows: int, halo: int) -> int:
    """Bytes of a row's slot: its tiles and its halo rounded up to 32 bytes,
    then up to the first length at which the lanes of each warp read
    different banks. Tile ``t`` of slot ``i`` starts at 32-byte unit ``i*s +
    t`` of the buffer, whose words lie on bank ``9 (i*s + t) mod 32``."""
    s, threads = tiles + -(-halo // 32), tiles * rows

    def clash(w0):
        lanes = range(w0, min(w0 + 32, threads))
        return len({(t // tiles * s + t % tiles) % 32 for t in lanes}) < len(lanes)

    while any(clash(w0) for w0 in range(0, threads, 32)):
        s += 1
    return 32 * s


@functools.lru_cache(maxsize=256)
def item_rows(wf: int, halo: int, n_piece: int, n_pat: int,
              smem_max: int = SMEM_OPTIN) -> Items:
    """Kernel D's :class:`Items` for rows of ``wf`` windows and ``halo``
    bytes, and a launch group of ``n_piece`` pieces of ``n_pat`` patterns.

    Where ``wf`` is a multiple of 32 and a row's ``wf // 32`` tiles are
    fewer than half of ``_MAX_THREADS``, an item takes as many whole rows as
    fill ``_MAX_THREADS`` threads, halved while the block's
    :func:`block_smem` passes ``smem_max``; otherwise a segment of one row,
    whole warps enough to tile ``wf`` up to ``_MAX_THREADS``, halved likewise
    down to one warp. Where nothing fits, the smallest block, which the
    entry refuses. (At ``wf`` = 4096, two rows an item ran as fast as one
    on an H100.)
    """
    tiles = wf // _TILE
    if wf % _TILE == 0 and 2 * tiles < _MAX_THREADS:
        rows = _MAX_THREADS // tiles
        while True:
            items = Items(rows, rows * tiles, _slot(tiles, rows, halo))
            if rows == 1 or block_smem(items, n_piece, n_pat) <= smem_max:
                return items
            rows //= 2
    threads = min(_MAX_THREADS, -(-wf // (32 * _TILE)) * 32)
    while True:
        items = Items(1, threads, _slot(threads, 1, halo))
        if threads <= 32 or block_smem(items, n_piece, n_pat) <= smem_max:
            return items
        threads //= 2


def launch_items(plens: tuple, k: int, wf: int, halo: int, smem_max: int = SMEM_OPTIN):
    """Kernel D's launches over these lengths: ``((p0, p1), Items)`` for
    each :func:`launch_groups` group, its :func:`item_rows`."""
    _, pstart = piece_layout(plens, k)
    return tuple(
        ((p0, p1), item_rows(wf, halo, int(pstart[p1] - pstart[p0]), p1 - p0, smem_max))
        for p0, p1 in launch_groups(pstart)
    )


def smem_optin(device: torch.device) -> int:
    """Shared memory a block may opt in to on ``device``: a card's own, else
    the H100's (``SMEM_OPTIN``), what kernel D is sized for off the card."""
    if device.type != "cuda":
        return SMEM_OPTIN
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def _check_args(rows, pat_raw, k, m_max, wf, halo, plens) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be 2-D uint8, got {rows.dtype} {tuple(rows.shape)}")
    if rows.shape[1] != wf + halo or rows.shape[0] <= 0:
        raise ValueError(f"rows shape {tuple(rows.shape)} != (R, wf + halo = {wf + halo})")
    if halo < m_max + 2 * k:
        raise ValueError(f"halo {halo} < m_max + 2k = {m_max + 2 * k}")
    if pat_raw.dtype != torch.uint8 or tuple(pat_raw.shape) != (len(plens), m_max):
        raise ValueError(
            f"pat_raw must be uint8 ({len(plens)}, {m_max}), got "
            f"{pat_raw.dtype} {tuple(pat_raw.shape)}"
        )
    bad = [m for m in plens if m != 0 and not (m <= m_max and filter_eligible(m, k))]
    if bad:
        raise ValueError(f"lengths {bad} are not filtration-eligible at k={k}")
    if pat_raw.device != rows.device:
        raise ValueError(f"rows on {rows.device}, pat_raw on {pat_raw.device}")


def scan_filter(
    rows: torch.Tensor,
    pat_raw: torch.Tensor,
    bound: int,
    start: int,
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
    plens: Sequence[int],
    plain: bool = False,
):
    """``(fcnt, rowmap)`` of this chunk (module contract).

    CUDA tensors go to kernel D (current stream, no synchronisation); CPU
    tensors, and any tensor under ``plain=True`` (the Scanner's
    ``backend="torch"``), to :func:`scan_filter_ref`.
    """
    plens = tuple(int(m) for m in plens)
    _check_args(rows, pat_raw, k, m_max, wf, halo, plens)
    if plain or rows.device.type == "cpu":
        return scan_filter_ref(
            rows, pat_raw, bound, start, k=k, m_max=m_max, wf=wf, halo=halo,
            plens=plens,
        )
    if rows.device.type != "cuda":
        raise ValueError(f"no filtration kernel for device {rows.device}")
    return _launch(rows, pat_raw, int(bound), int(start), k, wf, halo, plens)


def _launch(rows, pat_raw, bound, start, k, wf, halo, plens):
    global LAUNCHES
    from ._build import check, library
    from .corr_fused import check_aligned_rows

    rows = rows.contiguous()
    check_aligned_rows(rows, align=4)
    lib = library()
    dev = rows.device
    n_rows, n_pat = rows.shape[0], len(plens)
    fcnt = torch.zeros((n_pat,), dtype=torch.int32, device=dev)
    rowmap = torch.zeros((n_rows, n_pat), dtype=torch.int32, device=dev)
    if not any(plens):
        return fcnt, rowmap
    pad = sentinel_pad(plens, k)
    pchar = pchar_table(pat_raw, pad).contiguous()
    # the kernel builds the words from pchar: no device-to-host read here
    pstart_np = piece_layout(plens, k)[1]
    table, pstart = _device_layout(plens, k, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for (p0, p1), items in launch_items(plens, k, wf, halo, smem_optin(dev)):
        q0, q1 = int(pstart_np[p0]), int(pstart_np[p1])
        err = lib.apm_filter_pieces_count(
            rows.data_ptr(), n_rows, rows.shape[1],
            pchar[p0].data_ptr(), p1 - p0, pchar.shape[1], pad,
            table[q0].data_ptr(), q1 - q0, pstart[p0].data_ptr(),
            wf, bound, start,
            fcnt[p0].data_ptr(), rowmap.data_ptr() + 4 * p0, n_pat,
            items.rows, items.threads, items.slot, stream,
        )
        check(err, "apm_filter_pieces_count")
        LAUNCHES += 1
    return fcnt, rowmap


def scan_filter_ref(
    rows: torch.Tensor,
    pat_raw: torch.Tensor,
    bound: int,
    start: int,
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
    plens: Sequence[int],
):
    """Plain PyTorch version of kernel D, on any device: a direct
    transcription of ``apm``'s ``_filter_kernel``.

    Every piece's band is advanced over all ``wf + 2k`` lanes of every row
    at once. Piece 0 reads the text at ``lane + x - 1``; later pieces read
    it ``k`` lanes to the right (the TPU's pre-rotated tile, modular like
    its roll), so their hit at lane ``w + s + k`` belongs to window ``w``
    at shift ``s``.
    """
    plens = tuple(int(m) for m in plens)
    _check_args(rows, pat_raw, k, m_max, wf, halo, plens)
    dev = rows.device
    n_rows, wpf = rows.shape
    n_pat = len(plens)
    fcnt = torch.zeros((n_pat,), dtype=torch.int32, device=dev)
    rowmap = torch.zeros((n_rows, n_pat), dtype=torch.int32, device=dev)
    if not any(plens):
        return fcnt, rowmap
    pad = sentinel_pad(plens, k)
    pchar = pchar_table(pat_raw.cpu(), pad).tolist()
    text0 = rows.to(torch.int32)
    lanes = torch.arange(wf + 2 * k, device=dev)
    row = torch.arange(n_rows, device=dev, dtype=torch.int64)
    win = start + row[:, None] * wf + torch.arange(wf, device=dev)[None, :]
    valid = win < bound  # (R, wf)
    full = lambda v: torch.full((n_rows, wf + 2 * k), v, dtype=torch.int32, device=dev)

    for pi, m in enumerate(plens):
        if m == 0:
            continue
        j, kp = tier_of(m, k)
        pc = pchar[pi]
        cand = torch.zeros((n_rows, wf), dtype=torch.bool, device=dev)
        for pidx, (o, li) in enumerate(pieces_of_j(m, j)):
            delta = 0 if pidx == 0 else k
            band = [full(di - kp if di >= kp else INF) for di in range(2 * kp + 1)]
            mincap = None
            for x in range(o + 1, o + li + kp + 1):
                src = text0[:, (lanes + x - 1 - delta) % wpf]
                new, prev = [], None
                for di in range(2 * kp + 1):
                    d = di - kp
                    val = band[di] + (src != pc[x - 1 + d + pad]).to(torch.int32)
                    if d < kp:
                        val = torch.minimum(val, band[di + 1] + 1)  # deletion
                    if prev is not None:
                        val = torch.minimum(val, prev + 1)  # insertion
                    new.append(val)
                    prev = val
                band = new
                d = o + li - x  # capture D[li][li - d] at step o + li - d
                if -kp <= d <= kp:
                    cell = band[d + kp]
                    mincap = cell if mincap is None else torch.minimum(mincap, cell)
            hit = mincap <= kp  # (R, wf + 2k)
            s_lo, s_hi = piece_shift_range(pidx, j, o, li, m, k, kp)
            for s in range(s_lo, s_hi + 1):
                cand |= hit[:, s + delta : s + delta + wf]
        per_row = (cand & valid).sum(dim=1).to(torch.int32)
        rowmap[:, pi] = per_row
        fcnt[pi] = per_row.sum().to(torch.int32)
    return fcnt, rowmap
