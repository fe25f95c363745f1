"""Filtration phase 2 on the device (port of ``apm/ops/fused.py``).

Per chunk, phase 1 (kernel D, :func:`apm_torch.ops.filter_kernel.scan_filter`,
or the piece conv, :func:`apm_torch.ops.corr_engine.scan_pieces_conv`)
gives candidate totals and a per-row candidate map on the device. Phase 2
compacts the hot rows out of the staged chunk, which is already on the
device, and verifies them with the banded DP (kernel A, or kernel C in
Myers mode). The host gets one small packed vector per chunk,
``[fcnt (P) | vcnt (P) | n_hot (1) | clip_starts (MAX_CLIP)]``, fetched
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
    out[size] = fill
    return out[:size]


def _hot_rows(rowmap: torch.Tensor, bound, start: int, wf: int):
    """``(hot, full)`` row masks: a candidate in the row, and every window
    of the row below the bound."""
    r_rows = rowmap.shape[0]
    hot = rowmap.sum(dim=1) > 0
    row_start = start + torch.arange(r_rows, dtype=torch.int64, device=rowmap.device) * wf
    return hot, row_start + wf <= bound


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
    packed = torch.cat([
        fcnt.to(torch.int32),
        vcnt.to(torch.int32),
        n_hot.reshape(1).to(torch.int32),
        clip_starts.to(torch.int32),
    ])
    return packed, rowmap


def filter_verify_chunk(
    rows, pat_raw, pat, bound, start, *, k, m_max, wf, halo, plens,
    max_hot=MAX_HOT, alphabet=(), dp_impl="auto", peq=None, plain=False,
    spans=OFF,
):
    """Phase 1 through kernel D, then phase 2, for one staged chunk
    (k >= 1). Returns ``(packed, rowmap)``: the packed vector (module
    doc) and the ``(R, P)`` row map, both left on the device."""
    if k < 1:
        raise ValueError("k = 0 candidates are exact; call scan_filter")
    with spans.device("phase 1"):
        fcnt, rowmap = filter_kernel.scan_filter(
            rows, pat_raw, bound, start, k=k, m_max=m_max, wf=wf, halo=halo,
            plens=plens, plain=plain,
        )
    with spans.device("phase 2"):
        return _verify_phase2(
            rows, fcnt, rowmap, pat, bound, start, k=k, m_max=m_max, wf=wf,
            halo=halo, plens=plens, max_hot=max_hot, alphabet=alphabet,
            dp_impl=dp_impl, peq=peq, plain=plain,
        )


def filter_verify_chunk_conv(
    rows, pkern, pthr, owner, alph, pat, bound, start, *, k, m_max, wf,
    halo, plens, w_kern, n_rows, g_rows, fp1_stride=1, max_hot=MAX_HOT,
    alphabet=(), dp_impl="auto", peq=None, plain=False, spans=OFF,
):
    """:func:`filter_verify_chunk` with the piece conv as phase 1
    (:func:`apm_torch.ops.corr_engine.scan_pieces_conv`, plain PyTorch as
    ``apm`` leaves it to XLA). Its row map is a row-any superset of kernel
    D's; phase 2 is shared, so the counts are the same."""
    from .corr_engine import scan_pieces_conv

    if k < 1:
        raise ValueError("conv phase 1 needs k >= 1")
    with spans.device("phase 1"):
        fcnt, rowmap = scan_pieces_conv(
            rows, pkern, pthr, owner, alph, bound, start, wf=wf, w_kern=w_kern,
            n_rows=n_rows, g_rows=g_rows, stride=fp1_stride,
        )
    with spans.device("phase 2"):
        return _verify_phase2(
            rows, fcnt, rowmap, pat, bound, start, k=k, m_max=m_max, wf=wf,
            halo=halo, plens=plens, max_hot=max_hot, alphabet=alphabet,
            dp_impl=dp_impl, peq=peq, plain=plain,
        )


def count_hot_batch(
    rows, rowmap, pat, bound, start, b, *, k, m_max, wf, halo, plens,
    n_batch=OVERFLOW_BATCH, cap=OVERFLOW_CAP, alphabet=(), dp_impl="auto",
    peq=None, plain=False,
):
    """Overflow recovery on the device: ``(P,)`` counts over full hot rows
    ``[b*n_batch, (b+1)*n_batch)`` of the chunk (hot rows in row order,
    the ``hot & full`` rows of phase 2). The staged rows and the row map
    stay on the device."""
    if n_batch % FOLD or n_batch <= 0 or cap % n_batch:
        raise ValueError(f"n_batch {n_batch} / cap {cap}: need FOLD | n_batch | cap")
    r_rows = rows.shape[0]
    hot, full = _hot_rows(rowmap, bound, start, wf)
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
