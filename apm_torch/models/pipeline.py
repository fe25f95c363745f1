"""Scan planning and the filtration decision tree (port of
``apm/models/pipeline.py``).

* :class:`ScanPlan` / :func:`make_plan`: every derived layout quantity of a
  scan — block width, staging-row width and halo, the device-owned window
  bound, and the engine gating — exactly as ``apm``'s ``make_plan(scanner,
  n, "pallas")`` computes them, so both packages stage byte-identical rows
  and route the same patterns. Which kernel serves each group of patterns
  is decided in :class:`apm_torch.models.scanner.Scanner`.
* :func:`finalize_filtration`: the phase-2 decision tree over the fetched
  per-chunk results of :mod:`apm_torch.ops.fused` (zero candidates,
  density rescan, on-device verified counts, overflow recovery, clipped
  rows), with :func:`verify_rows_host` for overflow past the device
  compaction cap. The same tree takes the sharded scans of
  :mod:`apm_torch.parallel` (totals on the first chunk only, no device
  re-verify, row maps fetched lazily or not at all).

Corpus access is a ``reader(j0, length) -> np.ndarray`` (zero-padded past
EOF), as in ``apm``: :func:`buf_reader` over memory, :func:`file_reader`
over a file.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.common import round_up

if TYPE_CHECKING:  # pragma: no cover
    from .scanner import Scanner

# apm's DP fold for int32 cells (rows per Pallas block); the block width is
# rounded to fold x 128 windows, as in apm.
_FOLD = 8

Reader = Callable[[int, int], np.ndarray]


def buf_reader(buf: np.ndarray) -> Reader:
    """Reader over an in-memory corpus; zero-pads past EOF."""

    def read(j0: int, length: int) -> np.ndarray:
        seg = buf[j0 : j0 + length]
        if len(seg) == length:
            return np.asarray(seg)
        out = np.zeros(length, dtype=np.uint8)
        out[: len(seg)] = seg
        return out

    return read


def file_reader(path) -> Reader:
    """Reader over an on-disk corpus (native range reads; zero-padded)."""
    import os

    from ..utils import native

    path = os.fspath(path)
    return lambda j0, length: native.read_range(path, j0, length)


@dataclass(frozen=True)
class ScanPlan:
    """Derived layout for one scan: the quantities every path must agree on."""

    backend: str
    fold: int  # apm's DP sublane fold (block windows = fold * wf)
    w: int  # block windows (rounded to the fold x lane tile)
    wf: int  # windows per staging row
    halo: int  # staging-row overlap >= m_max + 2k, lane-aligned
    dev_bound: int  # exclusive bound of device-owned window starts
    engine: str  # "auto"/"filter"/"dp"/"corr" after fold gating
    fmask: tuple  # per-pattern: True when filtration-eligible
    plens_filter: tuple  # static lengths apm routes to the filtration kernel
    plens_dp: tuple  # static lengths routed to the banded DP kernel
    use_corr: bool = False  # k = 0 correlation engine takes the scan
    plens_corr: tuple = ()  # static lengths routed to the corr engine
    fp1_conv: bool = False  # k >= 1: apm runs filtration phase 1 as a conv

    @property
    def any_filter(self) -> bool:
        return any(self.plens_filter)

    @property
    def any_dp(self) -> bool:
        return any(self.plens_dp)


def check_dp_dtype(dp_dtype: str) -> None:
    """The port's DP cells are int32. ``apm``'s int16/int8 cells are
    interpreter-only test layouts on its side and have no kernel here."""
    if dp_dtype != "int32":
        raise NotImplementedError(
            f"dp_dtype={dp_dtype!r} is not ported; apm_torch computes int32 "
            "cells (see ROADMAP.md, Queue 2)"
        )


def make_plan(scanner: "Scanner", n: int) -> ScanPlan:
    """Compute the scan layout (``apm``'s device-path plan).

    The halo satisfies every kernel's lookahead: the banded kernel needs
    ``halo >= m_max - 1 + k`` bytes, apm's filtration kernel
    ``halo >= m_max + 2k`` — so ``round_up(m_max + 2k, 128)`` everywhere.
    """
    from ..ops.corr_engine import (
        ALPHABET_MAX,
        M_MAX_CORR,
        corr_eligible,
        fp1_conv_eligible,
    )
    from ..ops.filter_kernel import FOLD as FILTER_FOLD, partition_plens

    check_dp_dtype(scanner.config.dp_dtype)
    k = scanner.k
    fold = _FOLD
    w = round_up(scanner.block_windows_for(n), max(fold, FILTER_FOLD) * 128)
    halo = round_up(scanner.m_max + 2 * k, 128)
    engine = scanner.config.engine
    plens = scanner._plens_static
    alphabet_size = len(scanner._corr_alphabet())

    use_corr = False
    if k == 0 and engine in ("auto", "corr"):
        use_corr = corr_eligible(
            plens, alphabet_size, scanner.m_max, k, auto=engine == "auto"
        )
    if engine == "corr" and not use_corr:
        raise ValueError(
            "engine='corr' requires k == 0, a pattern alphabet of <= "
            f"{ALPHABET_MAX} distinct bytes, and m_max <= {M_MAX_CORR}"
        )
    if use_corr:
        zeros = tuple(0 for _ in plens)
        return ScanPlan(
            backend=scanner.backend,
            fold=fold,
            w=w,
            wf=w // fold,
            halo=halo,
            dev_bound=scanner.device_window_bound(n),
            engine="corr",
            fmask=tuple(False for _ in plens),
            plens_filter=zeros,
            plens_dp=zeros,
            use_corr=True,
            plens_corr=plens,
        )

    fmask, plens_filter, plens_dp = partition_plens(plens, k, engine)
    fp1_conv = False
    if engine == "auto" and any(plens_filter):
        fp1_conv = fp1_conv_eligible(plens_filter, k, alphabet_size)

    return ScanPlan(
        backend=scanner.backend,
        fold=fold,
        w=w,
        wf=w // fold,
        halo=halo,
        dev_bound=scanner.device_window_bound(n),
        engine=engine,
        fmask=fmask,
        plens_filter=plens_filter,
        plens_dp=plens_dp,
        fp1_conv=fp1_conv,
    )


@dataclass
class FilterChunk:
    """One chunk's (or shard's) fetched phase-2 results, and how to recover
    it if it overflowed its hot-row bucket."""

    c0: int  # global window start of the chunk
    # (P,) candidate totals; None when another chunk carries the summed
    # totals (the sharded scans put them on chunk 0)
    fcnt: Optional[np.ndarray]
    vcnt: Optional[np.ndarray]  # (P,) counts verified on the device; as fcnt
    n_hot: int  # full hot rows of the chunk
    clip_starts: np.ndarray  # (MAX_CLIP,) global starts of clipped hot rows
    # (R, P) row map: a device tensor, a callable that fetches it, or None
    # where no process can fetch it (a multi-process scan)
    rowmap: object = None
    # callable(n_hot) -> list of (P,) device count tensors over ALL the
    # chunk's full hot rows (fused.count_hot_batch), or None past the
    # compaction cap. Only a chunk whose vcnt is its own may carry one:
    # the sharded scans, whose vcnt is summed, leave it None.
    verify_dev: object = None


def candidate_density_dense(hot_rows: int, wf: int, dev_bound: int) -> bool:
    """Verification would touch more windows than ~5 % of the corpus (or
    64 rows): rescanning the filtration patterns with the banded DP is the
    cheaper route (``apm``'s threshold)."""
    return hot_rows * wf > max(64 * wf, dev_bound // 20)


def finalize_filtration(
    scanner: "Scanner",
    reader: Reader,
    plan: ScanPlan,
    n: int,
    chunks: Sequence[FilterChunk],
    rescan: Callable[[], np.ndarray],
    *,
    max_hot: int,
) -> np.ndarray:
    """Phase-2 decision tree over fetched per-chunk results (k >= 1),
    ``apm``'s branch for branch. Returns ``(p_pad,)`` int64 counts of the
    filtration patterns; ``rescan()`` must return banded-DP counts of
    ``plan.plens_filter`` over the whole device-owned range.

    ``scanner.last_filtration["route"]`` names the branch: "zero-candidates",
    "rescan" (density), "device-verify", or for an overflowed bucket
    "count_hot_batch" (re-verified on the device), "verify_rows_host"
    (rows staged from the host, found through the row maps) or
    "overflow-rescan" (a chunk without a fetchable row map: the banded
    rescan)."""
    p_pad = scanner._pat.shape[0]
    out = np.zeros((p_pad,), dtype=np.int64)
    if scanner.k < 1:
        raise ValueError("finalize_filtration is for k >= 1")

    fcnt = np.zeros((p_pad,), dtype=np.int64)
    vcnt = np.zeros((p_pad,), dtype=np.int64)
    n_hots: List[int] = []
    clips: List[int] = []
    for ch in chunks:
        if ch.fcnt is not None:
            fcnt += np.asarray(ch.fcnt, dtype=np.int64)
        if ch.vcnt is not None:
            vcnt += np.asarray(ch.vcnt, dtype=np.int64)
        n_hots.append(int(ch.n_hot))
        clips.extend(int(j0) for j0 in np.asarray(ch.clip_starts).ravel() if j0 >= 0)
    clips = sorted(set(clips))
    # The outcome, for callers that report the route taken.
    info = {"route": "zero-candidates", "n_hot": sum(n_hots), "max_hot": max_hot}
    scanner.last_filtration = info

    if int(fcnt.sum()) == 0:
        return out  # zero candidates: nothing to verify

    hot_total = sum(n_hots) + len(clips)
    if candidate_density_dense(hot_total, plan.wf, plan.dev_bound):
        info["route"] = "rescan"
        return rescan().astype(np.int64)

    overflow = [(ch, h) for ch, h in zip(chunks, n_hots) if h > max_hot]
    if overflow:
        batches = None
        if all(ch.verify_dev is not None for ch, _ in overflow):
            batches = [(ch, ch.verify_dev(h)) for ch, h in overflow]
            if any(b is None for _, b in batches):
                batches = None  # a chunk exceeded the compaction cap
        if batches is not None:
            # Re-verify each overflowed chunk's hot rows on the device; the
            # other chunks keep their on-device counts. One fetch.
            info["route"] = "count_hot_batch"
            handles = [h for _, hs in batches for h in hs]
            fetched = torch.stack(handles).cpu().numpy().astype(np.int64)
            redone = {id(ch) for ch, _ in overflow}
            for ch in chunks:
                if id(ch) not in redone:
                    out += np.asarray(ch.vcnt, dtype=np.int64)
            bi = 0
            for _, hs in batches:
                out += fetched[bi : bi + len(hs)].sum(axis=0)
                bi += len(hs)
        elif any(ch.rowmap is None for ch, _ in overflow):
            # No process can read the row maps: rescan the filtration set
            info["route"] = "overflow-rescan"
            return rescan().astype(np.int64)
        else:
            # Verify ALL full hot rows from host-staged copies (a summed
            # on-device vcnt cannot be split per chunk, so none is kept).
            info["route"] = "verify_rows_host"
            rows: List[int] = []
            for ch in chunks:
                rm = ch.rowmap
                rm = rm() if callable(rm) else rm
                rm = rm.cpu().numpy() if isinstance(rm, torch.Tensor) else np.asarray(rm)
                for r in np.nonzero(rm.any(axis=1))[0]:
                    j0 = ch.c0 + int(r) * plan.wf
                    if j0 + plan.wf <= plan.dev_bound:
                        rows.append(j0)
            out += verify_rows_host(scanner, reader, n, sorted(set(rows)), plan)
    else:
        info["route"] = "device-verify"
        out += vcnt

    # Clipped rows (at most one per chunk): verified on the host.
    for j0 in clips:
        out += _verify_clipped_row(scanner, reader, plan, n, j0, fcnt)
    return out


def verify_rows_host(
    scanner: "Scanner",
    reader: Reader,
    n: int,
    rows: Sequence[int],
    plan: ScanPlan,
) -> np.ndarray:
    """Verify full hot rows staged from the host: one ``(bucket, wf +
    halo)`` array, one banded-DP call over the filtration patterns."""
    from ..ops.filter_kernel import FOLD

    p_pad = scanner._pat.shape[0]
    out = np.zeros((p_pad,), dtype=np.int64)
    if not rows:
        return out
    wf, halo = plan.wf, plan.halo
    n_hot = len(rows)
    bucket = max(FOLD, round_up(n_hot, 4 * FOLD))
    stage = np.zeros((bucket, wf + halo), dtype=np.uint8)
    for i, j0 in enumerate(rows):
        stage[i] = reader(j0, wf + halo)
    drows = torch.from_numpy(stage).to(scanner.device)
    counts = scanner._scan_dp(drows, n_hot * wf, 0, plan.plens_filter, wf=wf, halo=halo)
    out += counts.cpu().numpy().astype(np.int64)
    return out


def _verify_clipped_row(
    scanner: "Scanner",
    reader: Reader,
    plan: ScanPlan,
    n: int,
    j0: int,
    fcnt: np.ndarray,
) -> np.ndarray:
    """Verify the window-bound-clipped hot row ``[j0, dev_bound)`` on the
    host with the native verifier (``apm``'s ``_verify_clipped_row``): the
    windows are untruncated, so no EOF truncation applies."""
    from ..utils import native

    k = scanner.k
    out = np.zeros((scanner._pat.shape[0],), dtype=np.int64)
    j1 = min(j0 + plan.wf, plan.dev_bound)
    if j0 >= j1:
        return out
    for pi, is_f in enumerate(plan.fmask):
        if not is_f or fcnt[pi] == 0:
            continue
        pat = scanner.scan_patterns.raw[pi]
        seg = reader(j0, min(n - j0, j1 - j0 + len(pat) - 1 + k))
        out[pi] += native.banded_count(seg, np.frombuffer(pat, np.uint8), k, j1 - j0)
    return out
