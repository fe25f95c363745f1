"""Filtration phase 2 on the device (port of ``apm/ops/fused.py``).

Per chunk (:func:`filter_verify_chunk`), phase 1 (kernel D,
:func:`apm_torch.ops.filter_kernel.scan_filter`, the piece conv,
:func:`apm_torch.ops.corr_engine.scan_pieces_conv`, or the fused piece
scan, :func:`apm_torch.ops.corr_fused.scan_pieces_fused`) gives candidate
totals and a per-row candidate map on the device. Phase 2 compacts the
hot rows out of the staged chunk, which is already on the device, and
verifies them with the banded DP (kernel A, or kernel C in Myers mode). The host gets one small packed vector per chunk,
``[fcnt (P) | vcnt (P) | n_hot (1) | clip_starts (MAX_CLIP)]``, int64 (a
clipped row's global start passes 2^31 in a genome's later chunks), fetched
together with every other chunk's after the chunk loop; overflow and
density are decided from it by
:func:`apm_torch.models.pipeline.finalize_filtration`.

Nothing here synchronises with the host: the compaction is a fixed-size
``cumsum`` plus scatter (no ``torch.nonzero``, no ``.item()``), and the
verify's window bound ``min(n_hot, max_hot) * wf`` stays in device memory,
where the DP kernels read it.

``plain=True`` runs the plain PyTorch versions of the kernels on any
device (the Scanner's ``backend="torch"``); otherwise a CUDA tensor goes to
the kernels and a CPU tensor to the plain versions. ``spans``
(:class:`apm_torch.utils.profiling.Spans`) times phase 1 and phase 2.

The second half holds ``Scanner.find``'s position helpers (``apm``'s
``fused.py:425-776``): per chunk, phase 1 through kernel D
(:func:`find_positions_chunk`) or a verdict-mask sweep of every row
(:func:`sweep_positions_chunk`), then hot-row compaction and the mask mode
of the DP kernels (:func:`apm_torch.ops.dp_kernel.scan_folded_dp_mask`),
whose verdicts become per-row positions on the device
(:func:`_row_topk_positions`) and a bit-packed mask
(:func:`_pack_mask_bits`). Nothing there synchronises with the host
either; ``Scanner.find`` fetches the small vectors of many chunks at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import OFF
from . import dp_kernel, filter_kernel
from .filter_kernel import FOLD

# Hot-row bucket floor of pick_max_hot (rows), a multiple of FOLD.
MAX_HOT = 64

# Clipped-row slots: at most one row per chunk straddles the window bound.
MAX_CLIP = 8

# Hot-row bucket ceiling of pick_max_hot (rows).
MAX_HOT_CAP = 1024

# Overflow recovery (count_hot_batch): rows re-verified per batch, and the
# compaction ceiling past which the host-staged path takes over.
OVERFLOW_BATCH = 512
OVERFLOW_CAP = 4096


def pick_max_hot(n_rows: int, wf: int, plens, k: int) -> int:
    """Size of the hot-row bucket that phase 2 verifies on the device
    (``apm``'s budget of ~64 verify operations per scanned window, between
    ``MAX_HOT`` and ``MAX_HOT_CAP`` rows, a multiple of ``FOLD``)."""
    ops_row = wf * sum(5 * (2 * k + 1) * m for m in plens if m > 0)
    budget_ops = n_rows * wf * 64
    cap = min(n_rows // 20, budget_ops // max(ops_row, 1))
    cap = int(min(MAX_HOT_CAP, max(MAX_HOT, cap), max(n_rows, FOLD)))
    return max(FOLD, (cap // FOLD) * FOLD)


def _compact(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of the first ``size`` true entries of a 1-D mask, in order,
    padded with ``fill``: ``jnp.nonzero(mask, size=size,
    fill_value=fill)`` with a fixed-size output and no host sync (each true
    entry is scattered to its running count; the rest land in a spill
    slot that is cut off)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=mask.device))
    # no store into the spill slot: a host scalar written to the card
    # would hold the host until the stream drained
    return out[:size]


def _hot_rows(rowmap: torch.Tensor, bound, start: int, wf: int, cols=None):
    """``(hot, full)`` row masks: a candidate in the row (in a column that
    ``cols``, a ``(P,)`` bool device mask, selects; every column when
    None), and every window of the row below the bound."""
    hot = rowmap.sum(dim=1) > 0 if cols is None else ((rowmap > 0) & cols).any(dim=1)
    return hot, _full_rows(rowmap, bound, start, wf)


def _full_rows(rowmap: torch.Tensor, bound, start: int, wf: int) -> torch.Tensor:
    """Row mask: every window of the row below the bound."""
    row_start = start + torch.arange(rowmap.shape[0], dtype=torch.int64, device=rowmap.device) * wf
    return row_start + wf <= bound


def pattern_hot_rows(rowmap: torch.Tensor, bound, start: int, wf: int) -> torch.Tensor:
    """``(2, P)`` int32: for each pattern, the chunk's full hot rows whose
    row-map column holds a candidate (``(rowmap[:, p] > 0) & full``, the
    rows phase 2 verifies, counted per pattern), and its clipped rows that
    do. The full rows' sum over a set of patterns bounds the rows of the
    set's union, whichever phase-1 engine made the row map."""
    full = _full_rows(rowmap, bound, start, wf)[:, None]
    hot = rowmap > 0
    return torch.stack([(hot & full).sum(dim=0, dtype=torch.int32),
                        (hot & ~full).sum(dim=0, dtype=torch.int32)])


def slot_mask(plens, device) -> torch.Tensor:
    """``(P,)`` bool device mask of the slots whose length in ``plens`` is
    nonzero, from the DP kernels' per-``plens`` device copy: no host
    transfer past a tuple's first use."""
    return dp_kernel._device_consts(tuple(int(m) for m in plens), (), device)[0] > 0


def _verify_rows(rows, idx, vbound, pat, **kw) -> torch.Tensor:
    """Banded-DP counts over the staged rows ``idx`` (row order), windows
    below the device-side ``vbound`` only. Indices past the chunk (the
    compaction's padding) read its last row; ``vbound`` masks them."""
    stage = rows.index_select(0, idx.clamp(max=rows.shape[0] - 1))
    return dp_kernel.scan_folded_dp(stage, pat, vbound, 0, **kw)


def _verify_phase2(
    rows, fcnt, rowmap, pat, bound, start, *, k, m_max, wf, halo, plens,
    max_hot, alphabet, dp_impl, peq, plain,
):
    """Shared phase 2 (``apm``'s ``_verify_phase2``): verify the first
    ``max_hot`` full hot rows on the device and pack the host-facing
    vector.

    ``apm`` picks among three buckets with ``lax.cond`` (skip, a quarter,
    all of ``max_hot``). The port has no device-side branch: it always
    verifies ``max_hot`` gathered rows, bounded by ``min(n_hot, max_hot) *
    wf`` in device memory. The DP kernels' blocks whose tiles lie past
    that bound exit at once, so a chunk with no hot row costs one
    near-empty launch and a lightly hot one pays for its hot rows only.
    """
    if max_hot % FOLD or max_hot <= 0:
        raise ValueError(f"max_hot {max_hot} must be a positive multiple of {FOLD}")
    r_rows = rows.shape[0]
    hot, full = _hot_rows(rowmap, bound, start, wf)
    use = hot & full
    n_hot = use.sum()
    idx = _compact(use, max_hot, r_rows)
    vbound = torch.clamp(n_hot, max=max_hot) * wf
    vcnt = _verify_rows(
        rows, idx, vbound, pat, plain=plain, k=k, m_max=m_max, wf=wf,
        halo=halo, plens=plens, alphabet=alphabet, dp_impl=dp_impl, peq=peq,
    )
    clip_idx = _compact(hot & ~full, MAX_CLIP, -1)
    clip_starts = torch.where(clip_idx >= 0, start + clip_idx * wf, -1)
    packed = torch.cat([fcnt, vcnt, n_hot.reshape(1), clip_starts]).to(torch.int64)
    return packed, rowmap


def filter_verify_chunk(
    rows, phase1, pat, bound, start, *, k, m_max, wf, halo, plens,
    max_hot=MAX_HOT, alphabet=(), dp_impl="auto", peq=None, plain=False,
    spans=OFF,
):
    """Phase 1, then phase 2, for one staged chunk (k >= 1). ``phase1(rows,
    bound=, start=)`` returns ``(fcnt, rowmap)``: kernel D
    (:func:`apm_torch.ops.filter_kernel.scan_filter`), or, where the plan
    runs it as a correlation, the piece conv
    (:func:`apm_torch.ops.corr_engine.scan_pieces_conv`, plain PyTorch as
    ``apm`` leaves it to XLA) or the fused piece scan (kernel #7,
    :func:`apm_torch.ops.corr_fused.scan_pieces_fused`), with their tables
    bound (``functools.partial``). The two correlations' row maps are
    row-any supersets of kernel D's; phase 2 is shared, so the counts are
    the same. Returns ``(packed, rowmap)``: the packed vector (module doc)
    and the ``(R, P)`` row map, both left on the device."""
    if k < 1:
        raise ValueError("k = 0 candidates are exact; call scan_filter")
    with spans.device("phase 1"):
        fcnt, rowmap = phase1(rows, bound=bound, start=start)
    with spans.device("phase 2"):
        return _verify_phase2(
            rows, fcnt, rowmap, pat, bound, start, k=k, m_max=m_max, wf=wf,
            halo=halo, plens=plens, max_hot=max_hot, alphabet=alphabet,
            dp_impl=dp_impl, peq=peq, plain=plain,
        )


def count_hot_batch(
    rows, rowmap, pat, bound, start, b, *, k, m_max, wf, halo, plens,
    n_batch=OVERFLOW_BATCH, cap=OVERFLOW_CAP, alphabet=(), dp_impl="auto",
    peq=None, plain=False, cols=None,
):
    """``(P,)`` counts of ``plens`` over full hot rows ``[b*n_batch,
    (b+1)*n_batch)`` of the chunk (hot rows in row order, the ``hot &
    full`` rows of phase 2), on the device: the overflow recovery, and the
    sparse patterns' verify on the "split-rescan" route of
    :func:`apm_torch.models.pipeline.finalize_filtration`. There ``cols``
    (:func:`slot_mask` of the sparse patterns' lengths, which ``plens``
    holds alone) makes a row hot only by a candidate of those patterns.
    The staged rows and the row map stay on the device; a batch past the
    device-side count of hot rows verifies nothing."""
    if n_batch % FOLD or n_batch <= 0 or cap % n_batch:
        raise ValueError(f"n_batch {n_batch} / cap {cap}: need FOLD | n_batch | cap")
    r_rows = rows.shape[0]
    hot, full = _hot_rows(rowmap, bound, start, wf, cols)
    use = hot & full
    n_hot = use.sum()
    idx = _compact(use, cap, r_rows)[b * n_batch : (b + 1) * n_batch]
    vbound = torch.clamp(n_hot - b * n_batch, 0, n_batch) * wf
    return _verify_rows(
        rows, idx, vbound, pat, plain=plain, k=k, m_max=m_max, wf=wf,
        halo=halo, plens=plens, alphabet=alphabet, dp_impl=dp_impl, peq=peq,
    )


def unpack_chunk(packed, p: int):
    """Split a fetched packed vector into ``(fcnt, vcnt, n_hot,
    clip_starts)``."""
    packed = np.asarray(packed)
    return (
        packed[:p],
        packed[p : 2 * p],
        int(packed[2 * p]),
        packed[2 * p + 1 : 2 * p + 1 + MAX_CLIP],
    )


# -- Scanner.find's position helpers --------------------------------------------

# Hot rows verified per gather batch of Scanner.find's position path (the
# bit-packed verdicts of a batch are FIND_BATCH * P * wf / 8 bytes).
FIND_BATCH = 512

# Per-row position cap: every verdict-mask row gets its first POS_CAP hit
# positions extracted on the device, so the host fetches a few KB of
# positions instead of the packed mask. A row with more hits than the cap
# is incomplete, and its batch falls back to the packed mask.
POS_CAP = 32

# Device budget of the dense sweep's per-group transients: the group's
# (g, P, wf) uint8 mask and the int32 keys of its per-row top-k, sized as
# apm sizes its int32 mask (P * wf * 4 bytes per row).
SWEEP_MASK_BYTES = 64 << 20


def _row_topk_positions(mask: torch.Tensor, p_real: int, wf: int, c: int):
    """Per-row top-k compaction of an ``(R, P, wf)`` verdict mask.

    Returns ``(pos (R, c) int32, cnt (R,) int32)``: for each row, the first
    ``c`` hit positions as ascending flat indices into ``(p_real, wf)``
    (-1 padding), and the exact per-row hit count (a row with ``cnt > c``
    is incomplete). The keys are ``apm``'s descending ``L - iota``, so the
    largest ``c`` keys are the first ``c`` hits in order.
    """
    r = mask.shape[0]
    flat = (mask[:, :p_real, :wf] != 0).reshape(r, -1)
    L = flat.shape[1]
    cc = min(c, L)
    iota = torch.arange(L, dtype=torch.int32, device=mask.device)
    keys = torch.where(flat, L - iota, torch.zeros_like(iota))
    v = torch.topk(keys, cc, dim=1).values
    pos = torch.where(v > 0, L - v, torch.full_like(v, -1)).to(torch.int32)
    if cc < c:
        pos = torch.nn.functional.pad(pos, (0, c - cc), value=-1)
    return pos, flat.sum(dim=1, dtype=torch.int32)


def _pack_mask_bits(mask: torch.Tensor, p_real: int) -> torch.Tensor:
    """Bit-pack an ``(R, P, wf)`` verdict mask to ``(R, p_real, wf // 8)``
    uint8: window ``j'`` of a row is bit ``j' % 8`` of byte ``j' // 8``.
    Viewed as little-endian uint32 words, these are ``apm``'s ``(R,
    p_real, wf // 32)`` uint32 words (bit ``j' % 32`` of word ``j' //
    32``)."""
    r, _, wf = mask.shape
    bits = (mask[:, :p_real, :] != 0).to(torch.uint8).reshape(r, p_real, wf // 8, 8)
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8, device=mask.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpack_mask_bits(packed: np.ndarray, pi: int, n_rows: int) -> np.ndarray:
    """Host-side inverse of :func:`_pack_mask_bits` for one pattern:
    ``(n_rows, wf)`` uint8 0/1 verdicts (``packed`` as bytes, or ``apm``'s
    uint32 words)."""
    sub = np.ascontiguousarray(packed[:n_rows, pi, :])
    return np.unpackbits(sub.view(np.uint8), bitorder="little").reshape(n_rows, -1)


def _gather_fill(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the staged chunk, zeros for indices ``>= R`` (the
    compaction's padding): ``jnp.take(..., mode="fill", fill_value=0)``."""
    r_rows = rows.shape[0]
    stage = rows.index_select(0, idx.clamp(max=r_rows - 1))
    return stage.masked_fill_((idx >= r_rows)[:, None], 0)


def gather_mask_rows(
    rows, idx, pat, n_real, *, k, m_max, wf, halo, plens, p_real, pos_cap,
    alphabet=(), dp_impl="auto", peq=None, plain=False,
):
    """Re-verify the staged rows ``idx`` (``(n_batch,)`` on the device,
    ``>= R`` for padding; ``n_real`` of them real) with the mask mode and
    return ``(posmeta, bits)``: ``[cnt (n_batch) | pos (n_batch *
    pos_cap)]`` (:func:`_row_topk_positions`) and the packed verdicts
    (:func:`_pack_mask_bits`), both left on the device."""
    stage = _gather_fill(rows, idx)
    _, mask = dp_kernel.scan_folded_dp_mask(
        stage, pat, int(n_real) * wf, 0, k=k, m_max=m_max, wf=wf, halo=halo,
        plens=plens, alphabet=alphabet, dp_impl=dp_impl, peq=peq, plain=plain,
    )
    pos, cnt = _row_topk_positions(mask, p_real, wf, pos_cap)
    return torch.cat([cnt, pos.reshape(-1)]), _pack_mask_bits(mask, p_real)


def _positions_tail(
    rows, fcnt, rowmap, pat, bound, start, *, k, m_max, wf, halo, plens,
    p_real, n_batch, pos_cap, alphabet, dp_impl, peq, plain,
):
    """Shared position tail (``apm``'s ``_positions_tail``): compact the
    first ``n_batch`` full hot rows out of the staged chunk, re-run them
    through the mask mode, and return ``(meta, pos, bits, rowmap)`` with
    ``meta = [fcnt (P) | n_hot | idx (n_batch) | cnt (n_batch) |
    clip_starts (MAX_CLIP)]`` (int64).

    ``apm`` packs the bits under a ``lax.cond`` only when some row passes
    ``pos_cap``. A branch on a device value has no sync-free counterpart
    here, so the bits are packed every time (one pass over the <= n_batch
    * P * wf byte mask); the host fetches them only when it sees a count
    past ``pos_cap``, as ``apm`` does."""
    if n_batch % FOLD or n_batch <= 0:
        raise ValueError(f"n_batch {n_batch} must be a positive multiple of {FOLD}")
    r_rows = rows.shape[0]
    hot, full = _hot_rows(rowmap, bound, start, wf)
    use = hot & full
    n_hot = use.sum()
    idx = _compact(use, n_batch, r_rows)
    vbound = torch.clamp(n_hot, max=n_batch) * wf
    _, mask = dp_kernel.scan_folded_dp_mask(
        _gather_fill(rows, idx), pat, vbound, 0, k=k, m_max=m_max, wf=wf,
        halo=halo, plens=plens, alphabet=alphabet, dp_impl=dp_impl, peq=peq,
        plain=plain,
    )
    clip_idx = _compact(hot & ~full, MAX_CLIP, -1)
    clip_starts = torch.where(clip_idx >= 0, start + clip_idx * wf, -1)
    pos, cnt = _row_topk_positions(mask, p_real, wf, pos_cap)
    meta = torch.cat([
        fcnt.to(torch.int64), n_hot.reshape(1).to(torch.int64), idx,
        cnt.to(torch.int64), clip_starts,
    ])
    return meta, pos, _pack_mask_bits(mask, p_real), rowmap


def find_positions_chunk(
    rows, pat_raw, pat, bound, start, *, k, m_max, wf, halo, plens, p_real,
    n_batch, pos_cap, alphabet=(), dp_impl="auto", peq=None, plain=False,
):
    """Positions of one staged chunk for filtration-eligible patterns
    (``apm``'s ``find_positions_chunk``): kernel D's row map, then
    :func:`_positions_tail`. Returns ``(meta, pos, bits, rowmap)``, all on
    the device."""
    fcnt, rowmap = filter_kernel.scan_filter(
        rows, pat_raw, bound, start, k=k, m_max=m_max, wf=wf, halo=halo,
        plens=plens, plain=plain,
    )
    return _positions_tail(
        rows, fcnt, rowmap, pat, bound, start, k=k, m_max=m_max, wf=wf,
        halo=halo, plens=plens, p_real=p_real, n_batch=n_batch,
        pos_cap=pos_cap, alphabet=alphabet, dp_impl=dp_impl, peq=peq,
        plain=plain,
    )


def sweep_positions_chunk(
    rows, pat, bound, start, *, k, m_max, wf, halo, plens, p_real,
    n_batch, pos_cap, alphabet=(), dp_impl="auto", peq=None, plain=False,
):
    """:func:`find_positions_chunk` for filtration-ineligible patterns
    (``apm``'s ``sweep_positions_chunk``): the mask mode sweeps every
    staged row, group by group (a Python loop over row groups sized from
    :data:`SWEEP_MASK_BYTES`, with no host sync). Each group's mask gives
    the per-row hit counts (the row map) and the first ``pos_cap``
    positions of every full row (``gpos``, with its counts ``gcnt``).

    Returns ``(meta, pos, gpos, bits, rowmap)``: the tail's ``meta`` with
    ``gcnt (R)`` appended, and ``gpos (R, pos_cap)``."""
    r_rows = rows.shape[0]
    g_cap = max(FOLD, SWEEP_MASK_BYTES // max(pat.shape[0] * wf * 4, 1))
    # Largest group <= g_cap that tiles the chunk (the chunk has a multiple
    # of FOLD rows, so FOLD always does).
    g = next(d for d in range(min(g_cap, r_rows), 0, -1) if r_rows % d == 0 and d % FOLD == 0)
    dp = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens,
              alphabet=alphabet, dp_impl=dp_impl, peq=peq, plain=plain)
    rowcnt, gcnt, gpos = [], [], []
    for g0 in range(0, r_rows, g):
        _, mask = dp_kernel.scan_folded_dp_mask(
            rows[g0 : g0 + g], pat, bound - start - g0 * wf, 0, **dp
        )
        rowcnt.append(mask.sum(dim=2, dtype=torch.int32))  # (g, P)
        # Positions of full rows only (clipped rows resolve on the host).
        ridx = torch.arange(g0, g0 + g, dtype=torch.int64, device=rows.device)
        full = (start + (ridx + 1) * wf) <= bound
        pos_g, cnt_g = _row_topk_positions(
            mask.masked_fill_(~full[:, None, None], 0), p_real, wf, pos_cap
        )
        gcnt.append(cnt_g)
        gpos.append(pos_g)
    rowmap = torch.cat(rowcnt)
    meta, pos, bits, rowmap = _positions_tail(
        rows, rowmap.sum(dim=0), rowmap, pat, bound, start, p_real=p_real,
        n_batch=n_batch, pos_cap=pos_cap, **dp,
    )
    return torch.cat([meta, torch.cat(gcnt).to(torch.int64)]), pos, torch.cat(gpos), bits, rowmap
