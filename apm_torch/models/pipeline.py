"""Scan planning and the filtration decision tree (port of
``apm/models/pipeline.py``).

* :class:`ScanPlan` / :func:`make_plan`: every derived layout quantity of a
  scan — block width, staging-row width and halo (:func:`staging`,
  :func:`chunking`), the device-owned window bound, and the engine gating
  — exactly as ``apm``'s ``make_plan(scanner, n, "pallas")`` computes
  them, so both packages stage byte-identical rows and route the same
  patterns; and which kernel serves each group of patterns
  (:class:`Routes`, :func:`routes_for`). Every path of the Scanner
  reads its layout and routes from here.
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
from typing import TYPE_CHECKING, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.common import round_up
from ..utils.profiling import OFF

if TYPE_CHECKING:  # pragma: no cover
    from .scanner import Scanner

# apm's DP fold for int32 cells (rows per Pallas block); the block width is
# rounded to fold x 128 windows, as in apm.
_FOLD = 8

Reader = Callable[[int, int], np.ndarray]
# scan_dp(rows, bound, start, plens) -> (p_pad,) device banded-DP counts over
# staged rows of the plan's layout (Scanner._scan_dp)
ScanDp = Callable[[torch.Tensor, int, int, tuple], torch.Tensor]


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
class Routes:
    """Which kernel runs each part of a scan (:func:`routes_for`)."""

    corr: Optional[str]  # the k = 0 correlation set: None, "fused" (kernel B) or "conv"
    # filtration phase 1 at k >= 1: None (kernel D), "fused" (kernel #7) or
    # "conv" (the piece conv)
    fp1: Optional[str]
    dp_mode: str  # the banded DP: "myers" (kernel C) or "band" (kernel A)

    def check(self, config) -> None:
        """Refuse a scan whose config demands a route it cannot have:
        ``engine="corr"`` without the correlation engine,
        ``corr_impl="fused"`` where the k = 0 set needs the conv (as
        ``apm`` refuses them)."""
        from ..ops.corr_engine import ALPHABET_MAX, M_MAX_CORR

        if config.engine == "corr" and self.corr is None:
            raise ValueError(
                "engine='corr' requires k == 0, a pattern alphabet of <= "
                f"{ALPHABET_MAX} distinct bytes, and m_max <= {M_MAX_CORR}"
            )
        if config.corr_impl == "fused" and self.corr == "conv":
            raise ValueError(
                "corr_impl='fused' requires m_max <= 97 and 128-aligned "
                "staging (apm_torch.ops.corr_fused.fused_eligible)"
            )


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
    routes: Routes
    plens_corr: tuple = ()  # static lengths routed to the corr engine

    @property
    def any_filter(self) -> bool:
        return any(self.plens_filter)

    @property
    def any_dp(self) -> bool:
        return any(self.plens_dp)

    @property
    def use_corr(self) -> bool:
        """The k = 0 correlation engine takes the scan."""
        return self.routes.corr is not None

    @property
    def fp1_conv(self) -> bool:
        """k >= 1: apm runs filtration phase 1 as a conv."""
        return self.routes.fp1 is not None


def check_dp_dtype(dp_dtype: str) -> None:
    """The port's DP cells are int32. ``apm``'s int16/int8 cells are
    interpreter-only test layouts on its side and have no kernel here."""
    if dp_dtype != "int32":
        raise NotImplementedError(
            f"dp_dtype={dp_dtype!r} is not ported; apm_torch computes int32 "
            "cells (see ROADMAP.md, Queue 2)"
        )


def staging(scanner: "Scanner", n: int) -> Tuple[int, int, int]:
    """``(w, wf, halo)`` of an ``n``-byte scan: the block width rounded to
    the fold x 128 windows, the windows of a staging row (``w / fold``),
    and a halo that holds every kernel's lookahead (the banded kernel
    needs ``m_max - 1 + k`` bytes, apm's filtration kernel ``m_max + 2k``),
    rounded to 128. So ``wf`` and ``halo`` are multiples of 128 and ``halo
    >= 128``: apm's staging checks of the fused kernels always hold, and
    :func:`routes_for` need not read them."""
    w = round_up(scanner.block_windows_for(n), _FOLD * 128)
    return w, w // _FOLD, round_up(scanner.m_max + 2 * scanner.k, 128)


def chunking(w: int, wf: int, span: int, chunk_bytes: int) -> Tuple[int, int]:
    """``(chunk_win, n_rows)``: ``span`` window starts are staged in chunks
    of ``chunk_win`` windows, a multiple of ``w`` near ``chunk_bytes`` (at
    least ``w``, at most ``span`` rounded up), of ``n_rows`` rows each."""
    chunk_win = max(w, round_up(min(chunk_bytes, span), w))
    return chunk_win, chunk_win // wf


def routes_for(plens: tuple, alphabet: tuple, m_max: int, k: int, config) -> Routes:
    """Which kernel runs each part of a scan, as ``apm``'s
    ``_count_pallas`` decides, from the pattern table (static lengths
    ``plens`` of every slot, its distinct bytes ``alphabet``, ``m_max``), k
    and the config. Routes, not fallbacks on failure: a kernel that fails
    to build or launch raises.

    ``corr``: kernel B where apm's fused gate holds (m_max <= 97), unless
    ``corr_impl="conv"``; else the conv (``apm``'s ``scan_corr_mxu``,
    here ``conv1d``). ``fp1``: where the plan runs filtration phase 1 as a
    correlation, kernel #7 under ``corr_impl="fused"`` where apm's gate
    ``fused_pieces_ok`` holds, else the piece conv (``apm``'s
    ``_fp1_call``). ``dp_mode``: ``apm``'s mode of the banded DP over the
    ``len(plens)`` slots (:func:`~apm_torch.ops.dp_kernel.resolve_dp_mode`).
    A route the config demands and cannot have is refused by
    :meth:`Routes.check`, not here: ``find`` and ``Scanner.tables`` read
    the routes of any config."""
    from ..ops.corr_engine import corr_eligible, fp1_conv_eligible
    from ..ops.corr_fused import fused_eligible, fused_pieces_ok
    from ..ops.dp_kernel import resolve_dp_mode
    from ..ops.filter_kernel import partition_plens

    engine, impl = config.engine, config.corr_impl
    corr = fp1 = None
    if k == 0 and engine in ("auto", "corr") and corr_eligible(
        plens, len(alphabet), m_max, k, auto=engine == "auto"
    ):
        corr = "fused" if impl != "conv" and fused_eligible(m_max) else "conv"
    elif engine == "auto":
        plens_filter = partition_plens(plens, k, engine)[1]
        if any(plens_filter) and fp1_conv_eligible(plens_filter, k, len(alphabet)):
            fp1 = "fused" if impl == "fused" and fused_pieces_ok(m_max) else "conv"
    dp_mode = resolve_dp_mode(k, alphabet, config.dp_dtype, config.dp_impl, len(plens), m_max)[1]
    return Routes(corr, fp1, dp_mode)


def make_plan(scanner: "Scanner", n: int) -> ScanPlan:
    """Compute the scan layout (``apm``'s device-path plan) and its routes
    (the Scanner's :func:`routes_for`, made once a Scanner)."""
    from ..ops.filter_kernel import partition_plens

    check_dp_dtype(scanner.config.dp_dtype)
    routes = scanner._routing
    routes.check(scanner.config)
    w, wf, halo = staging(scanner, n)
    plens, corr = scanner._plens_static, routes.corr is not None
    if corr:
        zeros = tuple(0 for _ in plens)
        fmask, plens_filter, plens_dp = tuple(False for _ in plens), zeros, zeros
    else:
        fmask, plens_filter, plens_dp = partition_plens(plens, scanner.k, scanner.config.engine)
    return ScanPlan(
        backend=scanner.backend,
        fold=_FOLD,
        w=w,
        wf=wf,
        halo=halo,
        dev_bound=scanner.device_window_bound(n),
        engine="corr" if corr else scanner.config.engine,
        fmask=fmask,
        plens_filter=plens_filter,
        plens_dp=plens_dp,
        routes=routes,
        plens_corr=plens if corr else (),
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
    # callable(n_hot, plens=None) -> list of (P,) device count tensors over
    # ALL the chunk's full hot rows (fused.count_hot_batch), or with plens
    # of those lengths over the rows hot in their columns, at most n_hot
    # rows; None past the compaction cap. Only a chunk whose vcnt is its
    # own may carry one: the sharded scans, whose vcnt is summed, leave it
    # None.
    verify_dev: object = None
    # (2, P) full and clipped hot rows per pattern (fused.pattern_hot_rows),
    # or None
    pattern_hot: Optional[np.ndarray] = None


def candidate_density_dense(hot_rows: int, wf: int, dev_bound: int) -> bool:
    """Verification would touch more windows than ~5 % of the corpus (or
    64 rows): rescanning the filtration patterns with the banded DP is the
    cheaper route (``apm``'s threshold)."""
    return hot_rows * wf > max(64 * wf, dev_bound // 20)


def sparse_patterns(
    pattern_hot: Sequence[np.ndarray], fmask, wf: int, dev_bound: int, cap: int
) -> Optional[np.ndarray]:
    """The filtration patterns a dense set can verify on their hot rows:
    ``(P,)`` bool, or None when that is none or all of them.

    ``pattern_hot`` holds each chunk's ``(P,)`` full hot rows per pattern.
    The filtration slots (``fmask``), in ascending order of their rows
    summed over the chunks, give the longest prefix whose summed rows
    stay within :func:`candidate_density_dense`'s threshold and, in every
    chunk, within ``cap`` (the device compaction's). The sum bounds the
    rows of the prefix's union, so these rows cost no more to verify than
    a set that is not dense."""
    per_chunk = np.asarray(pattern_hot, dtype=np.int64).reshape(len(pattern_hot), -1)
    slots = np.flatnonzero(fmask)
    order = slots[np.argsort(per_chunk[:, slots].sum(axis=0), kind="stable")]
    chunk_rows = np.cumsum(per_chunk[:, order], axis=1)
    fits = (~candidate_density_dense(chunk_rows.sum(axis=0), wf, dev_bound)
            & (chunk_rows <= cap).all(axis=0))
    n_s = int(np.argmin(fits)) if not fits.all() else len(order)
    if n_s in (0, len(order)):
        return None
    sparse = np.zeros((per_chunk.shape[1],), dtype=bool)
    sparse[order[:n_s]] = True
    return sparse


def finalize_filtration(
    reader: Reader,
    plan: ScanPlan,
    n: int,
    chunks: Sequence[FilterChunk],
    rescan: Callable[[], np.ndarray],
    *,
    k: int,
    patterns: Sequence[bytes],
    device: torch.device,
    scan_dp: ScanDp,
    max_hot: int,
    spans=OFF,
    rescan_some: Optional[Callable[[tuple], List[torch.Tensor]]] = None,
) -> Tuple[np.ndarray, dict]:
    """Phase-2 decision tree over fetched per-chunk results (k >= 1),
    ``apm``'s branch for branch, with one more branch below. Returns
    ``(counts, info)``: ``(p_pad,)`` int64 counts of the filtration
    patterns, and the outcome for ``Scanner.last_filtration``. ``rescan()``
    must return banded-DP counts of ``plan.plens_filter`` over the whole
    device-owned range. The host's branches read the raw scan ``patterns``
    and stage rows on ``device`` for ``scan_dp``.

    ``info["route"]`` names the branch: "zero-candidates",
    "rescan" (density), "split-rescan" (density, decided per pattern),
    "device-verify", or for an overflowed bucket "count_hot_batch"
    (re-verified on the device), "verify_rows_host" (rows staged from the
    host, found through the row maps) or "overflow-rescan" (a chunk
    without a fetchable row map: the banded rescan).

    "split-rescan" departs from ``apm``, whose density decision covers the
    whole set. Where the set is dense, every chunk carries ``verify_dev``
    and ``pattern_hot``, and ``rescan_some`` is given, the patterns that
    :func:`sparse_patterns` picks are verified on their full hot rows
    through ``verify_dev``, and on a clipped row on the host where they
    have a candidate in it; only the rest go to ``rescan_some(plens)``
    (device count handles of those lengths over the whole device-owned
    range). One read fetches both.
    ``info["sparse"]`` lists the verified slots.

    ``spans`` (:class:`~apm_torch.utils.profiling.Spans`) counts ``hot
    windows``, the windows of the hot rows that the density decision
    weighs, and ``candidates <slot>``, each filtration slot's candidate
    total, and brackets each blocking read of device counts as ``wait``."""
    p_pad = len(plan.fmask)
    out = np.zeros((p_pad,), dtype=np.int64)
    if k < 1:
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
    hot_total = sum(n_hots) + len(clips)
    spans.count("hot windows", hot_total * plan.wf)
    if spans.enabled:
        for slot in np.flatnonzero(plan.fmask):
            spans.count(f"candidates {slot}", fcnt[slot])

    if int(fcnt.sum()) == 0:
        return out, info  # zero candidates: nothing to verify

    if candidate_density_dense(hot_total, plan.wf, plan.dev_bound):
        sparse = None
        if rescan_some is not None and all(
            ch.verify_dev is not None and ch.pattern_hot is not None for ch in chunks
        ):
            from ..ops import fused

            sparse = sparse_patterns([ch.pattern_hot[0] for ch in chunks], plan.fmask,
                                     plan.wf, plan.dev_bound, fused.OVERFLOW_CAP)
        if sparse is None:
            info["route"] = "rescan"
            return rescan().astype(np.int64), info
        info["route"] = "split-rescan"
        info["sparse"] = np.flatnonzero(sparse).tolist()
        plens_s = tuple(m if s else 0 for m, s in zip(plan.plens_filter, sparse))
        plens_t = tuple(0 if s else m for m, s in zip(plan.plens_filter, sparse))
        handles = list(rescan_some(plens_t))
        for ch in chunks:
            rows = int(ch.pattern_hot[0][sparse].sum())
            if rows:
                handles += ch.verify_dev(rows, plens_s)
        fetched = torch.stack(handles)
        with spans.host("wait"):
            fetched = fetched.cpu()
        out += fetched.numpy().astype(np.int64).sum(axis=0)
        # A clipped row, on the host, for the sparse patterns with a
        # candidate in it: the rescan covers the rest.
        for ch in chunks:
            fcnt_s = np.where(sparse & (ch.pattern_hot[1] > 0), fcnt, 0)
            if fcnt_s.any():
                for j0 in np.asarray(ch.clip_starts).ravel():
                    if j0 >= 0:
                        out += _verify_clipped_row(reader, plan, n, int(j0), fcnt_s,
                                                   k=k, patterns=patterns)
        return out, info

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
            fetched = torch.stack(handles)
            with spans.host("wait"):
                fetched = fetched.cpu()
            fetched = fetched.numpy().astype(np.int64)
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
            return rescan().astype(np.int64), info
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
            out += verify_rows_host(reader, sorted(set(rows)), plan, device=device,
                                    scan_dp=scan_dp, spans=spans)
    else:
        info["route"] = "device-verify"
        out += vcnt

    # Clipped rows (at most one per chunk): verified on the host.
    for j0 in clips:
        out += _verify_clipped_row(reader, plan, n, j0, fcnt, k=k, patterns=patterns)
    return out, info


def verify_rows_host(
    reader: Reader,
    rows: Sequence[int],
    plan: ScanPlan,
    *,
    device: torch.device,
    scan_dp: ScanDp,
    spans=OFF,
) -> np.ndarray:
    """Verify full hot rows staged from the host: one ``(bucket, wf +
    halo)`` array on ``device``, one ``scan_dp`` call over the filtration
    patterns; the read of its counts is ``spans``'s ``wait``."""
    from ..ops.filter_kernel import FOLD

    out = np.zeros((len(plan.fmask),), dtype=np.int64)
    if not rows:
        return out
    wf, halo = plan.wf, plan.halo
    n_hot = len(rows)
    bucket = max(FOLD, round_up(n_hot, 4 * FOLD))
    stage = np.zeros((bucket, wf + halo), dtype=np.uint8)
    for i, j0 in enumerate(rows):
        stage[i] = reader(j0, wf + halo)
    counts = scan_dp(torch.from_numpy(stage).to(device), n_hot * wf, 0, plan.plens_filter)
    with spans.host("wait"):
        counts = counts.cpu()
    out += counts.numpy().astype(np.int64)
    return out


def _verify_clipped_row(
    reader: Reader,
    plan: ScanPlan,
    n: int,
    j0: int,
    fcnt: np.ndarray,
    *,
    k: int,
    patterns: Sequence[bytes],
) -> np.ndarray:
    """Verify the window-bound-clipped hot row ``[j0, dev_bound)`` on the
    host with the native verifier (``apm``'s ``_verify_clipped_row``): the
    windows are untruncated, so no EOF truncation applies."""
    from ..utils import native

    out = np.zeros((len(plan.fmask),), dtype=np.int64)
    j1 = min(j0 + plan.wf, plan.dev_bound)
    if j0 >= j1:
        return out
    for pi, is_f in enumerate(plan.fmask):
        if not is_f or fcnt[pi] == 0:
            continue
        pat = patterns[pi]
        seg = reader(j0, min(n - j0, j1 - j0 + len(pat) - 1 + k))
        out[pi] += native.banded_count(seg, np.frombuffer(pat, np.uint8), k, j1 - j0)
    return out
