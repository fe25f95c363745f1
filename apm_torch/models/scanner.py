"""End-to-end scan pipeline (port of ``apm/models/scanner.py``).

A :class:`Scanner` owns the pattern tables, plans a scan with
:func:`apm_torch.models.pipeline.make_plan` (the same plan as ``apm``),
stages the corpus into overlapping rows chunk by chunk (kept on the device
in a byte-bounded LRU keyed by the corpus's content, so a repeated corpus
is served from device memory), launches the kernels of every chunk
without synchronising, fetches all per-chunk counts once, and adds the
EOF-truncated tail windows counted on the host by the native verifier.
:meth:`Scanner.count_batch` does the same for many corpora in one staging
space, :meth:`Scanner.find` returns match positions, :meth:`Scanner.
count_file` and :meth:`Scanner.count_stream` read a file or a stream, and
:meth:`Scanner.warmup` (or ``ApmConfig.prewarm_bytes``, on a thread)
builds and drives every path once before the first request.

:meth:`Scanner.count` runs on one device or, as ``ApmConfig.strategy``
and ``max_devices`` decide (``apm``'s dispatch), on several: the window
axis or the pattern axis sharded over the visible cards
(:mod:`apm_torch.parallel.strategies`); :func:`apm_torch.parallel.
multihost.count_multihost` spreads a file over the processes of a
``torch.distributed`` group. ``count_batch``, ``find`` and ``warmup``
stay on one device, as in ``apm``; ``count_file`` and ``count_stream``
scan through ``count``.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.common import fold_corpus, round_up
from ..utils.config import ApmConfig
from ..utils.io import PatternSet
from ..utils.oracle import Bytes, as_u8
from ..utils.profiling import OFF, Spans

# An argument left out (``_count_device``'s ``fp``): None is a valid key.
_UNSET = object()


class Scanner:
    """Counts, for each pattern, the windows within edit distance <= k.

    Usage::

        sc = Scanner(["GATTACA", "CCCTTT"], k=2)
        counts = sc.count(corpus_bytes)   # np.ndarray (P,) int64
    """

    def __init__(
        self,
        patterns: Sequence[Bytes],
        k: int,
        config: Optional[ApmConfig] = None,
    ):
        if k < 0:
            raise ValueError("approx factor k must be >= 0")
        self.k = int(k)
        self.config = (config or ApmConfig()).validate()
        self._check_config()
        self.device = torch.device(self.config.device)
        if self.config.backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"backend='cuda' runs the CUDA kernels and needs a CUDA "
                f"device, got device={self.config.device!r}"
            )
        self.patterns = PatternSet.from_patterns(patterns)
        self.m_max = self.patterns.max_len

        # Deduplicate patterns: identical patterns share one scan and the
        # counts are expanded afterwards (the reference's own smoke test
        # sends the same 50-char line five times).
        raw = list(self.patterns.raw)
        if self.config.dedup_patterns:
            uniq: List[bytes] = []
            index: Dict[bytes, int] = {}
            inverse = []
            for r in raw:
                if r not in index:
                    index[r] = len(uniq)
                    uniq.append(r)
                inverse.append(index[r])
            self._inverse = np.asarray(inverse, dtype=np.int64)
        else:
            uniq = raw
            self._inverse = np.arange(len(raw), dtype=np.int64)
        self.scan_patterns = PatternSet.from_patterns(uniq)

        from ..ops.corr_engine import build_alphabet

        pat_packed, plen = self.scan_patterns.packed(self.k)
        # Pattern axis padded to a multiple of 8 as in apm; padding rows
        # have length 0 and generate no work in the kernels.
        p_pad = max(8, round_up(self.scan_patterns.num_patterns, 8))
        self._pat = np.zeros((p_pad, pat_packed.shape[1]), dtype=np.uint8)
        self._pat[: pat_packed.shape[0]] = pat_packed
        self._plen = np.zeros((p_pad,), dtype=np.int32)
        self._plen[: plen.shape[0]] = plen
        self._plens_static = tuple(int(x) for x in self._plen)
        self._pat_raw = np.zeros((p_pad, self.m_max), dtype=np.uint8)
        self._pat_raw[: self.scan_patterns.num_patterns] = (
            self.scan_patterns.table
        )
        self._alph = build_alphabet(self.scan_patterns.raw)
        self._fused_np = None  # (km, thr) NumPy tables, built on demand
        self._corr_kern_np = None  # (kern, thr, stride) of the k = 0 conv
        self._fp1_np = None  # (plens_filter, (kern, thr, owner, stride))
        self._fp1_fused_np = None  # (plens_filter, (km, thr, owner64))
        self._peq_np = None  # Myers-mode PEQ table, built on demand
        self._dev_tables: Dict[str, object] = {}  # device copies

        from ..utils.profiling import Meter

        self.last_duration: Optional[float] = None
        self.last_strategy: Optional[str] = None
        # The last scan's filtration outcome (pipeline.finalize_filtration):
        # route taken, full hot rows, hot-row bucket; None without phase 2.
        self.last_filtration: Optional[dict] = None
        # The last find's device branches, per path ("filter", "dense"):
        # counts of batches resolved from per-row positions ("rows"), from
        # the packed mask ("bits"), of gpos decodes ("gpos") and of gather
        # batches ("gather").
        self.last_find: Dict[str, Dict[str, int]] = {}
        self.meter = Meter()

        # Device corpus cache: (fingerprint, wf, halo, n_rows, c0) -> the
        # chunk's staged rows on the device, least recently used first,
        # bounded in bytes (_cache_byte_budget).
        self._dev_cache: Dict[tuple, torch.Tensor] = {}
        # Guards _dev_cache's inserts, evictions and iteration: the prewarm
        # thread (warmup's purge) runs beside foreground scans.
        self._dev_cache_lock = threading.RLock()
        # id -> (weakref, fingerprint, sample) of immutable buffers
        # (_corpus_fp).
        self._fp_memo: Dict[int, tuple] = {}
        self._stream_scanner: Optional["Scanner"] = None
        # Shared host fold cache (key -> folded host rows), set on the
        # pattern-shard sub-scanners of patterns_over_devices so the corpus
        # is folded once for every group; its lock is the parent's.
        self._fold_cache: Optional[Dict[tuple, torch.Tensor]] = None
        self._fold_cache_lock = threading.Lock()
        # Sub-scanners of the distribution strategies, cached per layout
        # (_replicas, _pattern_shard_scanners).
        self._replica_scanners: Dict[torch.device, "Scanner"] = {}
        self._shard_scanners_key: Optional[tuple] = None
        self._shard_scanners: List["Scanner"] = []
        self._prewarm_thread: Optional[threading.Thread] = None
        self._prewarm_error: Optional[BaseException] = None
        if self.config.prewarm_bytes:
            self._prewarm_thread = threading.Thread(
                target=self._prewarm_run,
                args=(int(self.config.prewarm_bytes),),
                name="apm-prewarm",
                daemon=True,
            )
            self._prewarm_thread.start()

    def _prewarm_run(self, corpus_bytes: int) -> None:
        """The prewarm thread's body: :meth:`warmup`, with a failure kept
        for :meth:`prewarm_join` to raise (a failed kernel build must not
        hide until the first scan)."""
        try:
            self.warmup(corpus_bytes)
        except Exception as e:  # the thread's boundary: kept and re-raised
            self._prewarm_error = e

    def prewarm_join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the background prewarm (``ApmConfig.prewarm_bytes``).

        Returns True when the prewarm has finished (or none was requested),
        False when ``timeout`` ran out first. Raises what the prewarm
        raised, every time it is asked, once the thread has ended.
        """
        t = self._prewarm_thread
        if t is None:
            return True
        t.join(timeout)
        if t.is_alive():
            return False
        if self._prewarm_error is not None:
            raise RuntimeError("the Scanner's prewarm failed") from self._prewarm_error
        return True

    # -- configuration --------------------------------------------------------

    def _check_config(self) -> None:
        """Refuse, up front, the options whose engine the port lacks."""
        from .pipeline import check_dp_dtype

        check_dp_dtype(self.config.dp_dtype)

    @property
    def backend(self) -> str:
        """"cuda" (hand-written kernels) or "torch" (plain versions)."""
        if self.config.backend != "auto":
            return self.config.backend
        return "cuda" if self.device.type == "cuda" else "torch"

    # -- pattern tables -------------------------------------------------------

    def _corr_alphabet(self) -> np.ndarray:
        """Distinct pattern bytes, sorted — the correlation tables' codes."""
        return self._alph

    def _dp_alphabet(self) -> tuple:
        """Distinct pattern bytes as a tuple: the alphabet of the
        bit-parallel (Myers) band, whose gate is
        :func:`apm_torch.ops.dp_kernel._myers_mode`."""
        return tuple(int(b) for b in self._corr_alphabet())

    def _corr_fused_tables(self):
        """``(km, thr)`` phase-folded ±1 tables over the real patterns
        (``apm``'s ``Scanner._corr_fused_tables``), built on demand."""
        if self._fused_np is None:
            from ..ops.corr_fused import build_fused_tables

            n_real = self.scan_patterns.num_patterns
            self._fused_np = build_fused_tables(
                self._pat_raw[:n_real],
                self._plens_static[:n_real],
                self._alph,
            )
        return self._fused_np

    def _corr_kernel(self):
        """``(kern, thr, stride)``: the k = 0 correlation conv's tables over
        the real patterns (``apm``'s ``Scanner._corr_kernel``: padding rows
        would only add all-zero channels), built on demand. The scan pads
        its counts back to the pattern table's rows (``p_out``)."""
        if self._corr_kern_np is None:
            from ..ops.corr_engine import build_kernel, pick_stride

            n_real = self.scan_patterns.num_patterns
            stride = pick_stride(n_real)
            kern, thr = build_kernel(
                self._pat_raw[:n_real], self._plens_static[:n_real], self._alph,
                stride=stride,
            )
            self._corr_kern_np = (kern, thr, stride)
        return self._corr_kern_np

    def _fp1_fused_tables(self, plens_filter: tuple):
        """``(km, thr, owner64)``: the fused piece scan's tables for conv
        phase 1 under ``corr_impl="fused"`` (``apm``'s
        ``Scanner._fp1_fused_tables``, over the full padded ``_pat_raw``),
        cached per split."""
        if self._fp1_fused_np is not None and self._fp1_fused_np[0] == plens_filter:
            return self._fp1_fused_np[1]
        from ..ops.corr_fused import build_fused_piece_tables

        tables = build_fused_piece_tables(
            self._pat_raw, plens_filter, self.k, self._corr_alphabet()
        )
        self._fp1_fused_np = (plens_filter, tables)
        return tables

    def _fp1_fused_plens(self) -> Optional[tuple]:
        """The filtration lengths of a scan whose conv phase 1 runs the
        fused piece scan (``engine="auto"``, ``corr_impl="fused"``, m_max
        <= 65 under the plan's 128-aligned staging), else None."""
        from ..ops.corr_fused import M_MAX_PIECES

        cfg = self.config
        if cfg.engine != "auto" or cfg.corr_impl != "fused" or self.m_max > M_MAX_PIECES:
            return None
        return self._fp1_plens()

    def _fp1_kernel(self, plens_filter: tuple):
        """Piece-correlation tables for conv phase 1, ``(kern, thr, owner,
        stride)`` (``apm``'s ``Scanner._fp1_kernel``), cached per split."""
        if self._fp1_np is not None and self._fp1_np[0] == plens_filter:
            return self._fp1_np[1]
        from ..ops.corr_engine import build_piece_kernel, pick_stride
        from ..ops.filter_kernel import tier_of

        n_pieces = sum(tier_of(m, self.k)[0] for m in plens_filter if m > 0)
        stride = pick_stride(n_pieces)
        tables = build_piece_kernel(
            self._pat_raw, plens_filter, self.k, self._corr_alphabet(),
            stride=stride,
        ) + (stride,)
        self._fp1_np = (plens_filter, tables)
        return tables

    def _fp1_plens(self) -> Optional[tuple]:
        """The filtration lengths of an ``engine="auto"`` scan when it runs
        conv phase 1, else None."""
        from ..ops.corr_engine import fp1_conv_eligible
        from ..ops.filter_kernel import partition_plens

        plens = partition_plens(self._plens_static, self.k, "auto")[1]
        if any(plens) and fp1_conv_eligible(plens, self.k, len(self._alph)):
            return plens
        return None

    def _myers_table_ok(self) -> bool:
        """Can the bit-parallel band represent this pattern table?"""
        from ..ops.dp_kernel import _myers_mode

        return _myers_mode(
            self.k, self._dp_alphabet(), "int32", "myers",
            len(self._plens_static), self.m_max,
        )

    def _peq(self) -> np.ndarray:
        """The Myers-mode PEQ table of the pattern table, built on demand."""
        if self._peq_np is None:
            from ..ops.dp_kernel import build_peq

            self._peq_np = build_peq(
                self._pat, self.k, self.m_max, self._dp_alphabet()
            )
        return self._peq_np

    def tables(self) -> Dict[str, np.ndarray]:
        """The scanner's tables as NumPy arrays — the keys
        :meth:`load_tables` takes. ``km``/``thr`` only when the pattern set
        fits the fused correlation tables (m_max <= 97); ``pkern``,
        ``pthr``, ``owner`` and ``stride`` only when an ``engine="auto"``
        scan runs conv phase 1; ``pieces_km``, ``pieces_thr`` and
        ``pieces_owner64`` (``apm``'s ``_fp1_fused_tables``) only when that
        phase runs the fused piece scan (:meth:`_fp1_fused_plens`); ``peq``
        only when the bit-parallel band can represent the table."""
        from ..ops.corr_fused import M_MAX_FUSED

        out = {
            "pat": self._pat,
            "plen": self._plen,
            "pat_raw": self._pat_raw,
            "alphabet": self._alph,
        }
        if self.m_max <= M_MAX_FUSED:
            km, thr = self._corr_fused_tables()
            out["km"], out["thr"] = km, thr
        plens = self._fp1_plens()
        if plens is not None:
            kern, thr, owner, stride = self._fp1_kernel(plens)
            out["pkern"], out["pthr"], out["owner"] = kern, thr, owner
            out["stride"] = np.asarray(stride, dtype=np.int64)
        plens = self._fp1_fused_plens()
        if plens is not None:
            km, thr, owner64 = self._fp1_fused_tables(plens)
            out["pieces_km"], out["pieces_thr"], out["pieces_owner64"] = km, thr, owner64
        if self._myers_table_ok():
            out["peq"] = self._peq()
        return out

    def load_tables(self, arrays: Dict[str, np.ndarray]) -> None:
        """Take the tables of an ``apm.Scanner`` over the same patterns.

        ``arrays`` holds ``pat`` (k-padded table), ``plen``, ``pat_raw``,
        ``alphabet`` and optionally ``km`` (bf16 cast to float32, or int8)
        and ``thr``, the piece tables ``pkern`` (bf16 cast to float32),
        ``pthr``, ``owner`` and ``stride``, the fused piece tables
        ``pieces_km`` (bf16 cast to float32, or int8), ``pieces_thr`` and
        ``pieces_owner64``, and ``peq`` — NumPy arrays, as
        :meth:`tables` returns them. They replace this scanner's own tables
        and are moved to its device; a table whose shape or dtype does not
        fit this pattern set raises.
        """
        own = self.tables()

        def take(name, like=None):
            a = np.asarray(arrays[name])
            like = own[name] if like is None else like
            if a.shape != like.shape or a.dtype != like.dtype:
                raise ValueError(
                    f"table {name!r}: {a.dtype} {a.shape}, expected "
                    f"{like.dtype} {like.shape}"
                )
            return np.array(a)  # a writable copy, whatever the caller passed

        pat, plen, pat_raw, alph = (
            take(name) for name in ("pat", "plen", "pat_raw", "alphabet")
        )
        fused = None
        if "km" in arrays or "thr" in arrays:
            km = np.asarray(arrays["km"])
            if km.dtype != np.int8:
                km = km.astype(np.float32)
            thr = np.asarray(arrays["thr"])
            fused = (np.ascontiguousarray(km), np.ascontiguousarray(thr))
        fp1 = None
        if "pkern" in arrays:
            plens = self._fp1_plens()
            if plens is None:
                raise ValueError("piece tables given, but no conv phase 1 runs")
            kern = np.ascontiguousarray(np.asarray(arrays["pkern"]), dtype=np.float32)
            if kern.shape != own["pkern"].shape:
                raise ValueError(
                    f"table 'pkern': shape {kern.shape}, expected {own['pkern'].shape}"
                )
            fp1 = (plens, (kern, take("pthr"), take("owner"), take("stride").item()))
        fp1_fused = None
        if "pieces_km" in arrays:
            plens = self._fp1_fused_plens()
            if plens is None:
                raise ValueError("fused piece tables given, but no fused phase 1 runs")
            km = np.asarray(arrays["pieces_km"])
            if km.dtype != np.int8:
                km = km.astype(np.float32)
            if km.shape != own["pieces_km"].shape:
                raise ValueError(
                    f"table 'pieces_km': shape {km.shape}, expected {own['pieces_km'].shape}"
                )
            owner64 = np.ascontiguousarray(np.asarray(arrays["pieces_owner64"]), dtype=np.float32)
            if owner64.shape != own["pieces_owner64"].shape:
                raise ValueError(
                    f"table 'pieces_owner64': shape {owner64.shape}, expected "
                    f"{own['pieces_owner64'].shape}"
                )
            thr = np.ascontiguousarray(np.asarray(arrays["pieces_thr"]))
            fp1_fused = (plens, (np.ascontiguousarray(km), thr, owner64))
        peq = take("peq") if "peq" in arrays else None
        self._pat, self._plen, self._pat_raw, self._alph = pat, plen, pat_raw, alph
        self._plens_static = tuple(int(x) for x in plen)
        self._fused_np, self._fp1_np, self._peq_np = fused, fp1, peq
        self._fp1_fused_np, self._corr_kern_np = fp1_fused, None
        self._dev_tables = {}
        self._device_tables(fused_needed=fused is not None)

    def _device_tables(self, fused_needed: bool) -> Dict[str, object]:
        """Device copies of the tables (made once each)."""
        t = self._dev_tables
        if "pat" not in t:
            t["pat"] = torch.from_numpy(self._pat).to(self.device)
            t["pat_raw"] = torch.from_numpy(self._pat_raw).to(self.device)
            t["alph"] = torch.from_numpy(self._alph).to(self.device)
        if fused_needed and "fused" not in t:
            from ..ops.corr_fused import FusedTables, pick_s

            km, thr = self._corr_fused_tables()
            t["fused"] = FusedTables.from_numpy(
                km, thr, self._alph, pick_s(self.m_max), self.device
            )
        return t

    def _device_corr_conv(self):
        """The k = 0 correlation conv's tables on the device: ``(kern, thr,
        stride)``."""
        t = self._dev_tables
        if "corr_conv" not in t:
            kern, thr, stride = self._corr_kernel()
            t["corr_conv"] = (
                torch.from_numpy(kern).to(self.device),
                torch.from_numpy(thr).to(self.device),
                stride,
            )
        return t["corr_conv"]

    def _device_fp1_fused(self, plens_filter: tuple):
        """The fused piece scan's tables on the device
        (:class:`~apm_torch.ops.corr_fused.PieceTables`)."""
        t = self._dev_tables
        if t.get("fp1_fused_key") != plens_filter:
            from ..ops.corr_fused import PieceTables

            km, thr, owner64 = self._fp1_fused_tables(plens_filter)
            t["fp1_fused"] = PieceTables.from_numpy(km, thr, owner64, self._alph, self.device)
            t["fp1_fused_key"] = plens_filter
        return t["fp1_fused"]

    def _device_peq(self) -> torch.Tensor:
        t = self._dev_tables
        if "peq" not in t:
            t["peq"] = torch.from_numpy(self._peq()).to(self.device)
        return t["peq"]

    def _device_fp1(self, plens_filter: tuple):
        """Conv phase 1 tables on the device: ``(kern, thr, owner,
        stride)``."""
        t = self._dev_tables
        if t.get("fp1_key") != plens_filter:
            kern, thr, owner, stride = self._fp1_kernel(plens_filter)
            t["fp1"] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (kern, thr, owner)
            ) + (stride,)
            t["fp1_key"] = plens_filter
        return t["fp1"]

    # -- single-device scan ---------------------------------------------------

    def device_window_bound(self, n: int) -> int:
        """Exclusive bound of device-owned window starts.

        The device scans untruncated windows ``j <= n - m_max``; the <=
        ``m_max - 1`` EOF-truncated windows (``sequential.c:131-134``) are
        counted on the host by :meth:`tail_counts`.
        """
        return max(0, min(n - self.m_max + 1, n - self.k))

    def tail_counts(self, buf: np.ndarray, dev_bound: int) -> np.ndarray:
        """Counts of the EOF tail windows ``j in [dev_bound, n-k)``, per
        scan (deduplicated) pattern, by the native verifier with the
        reference's EOF truncation (``apm``'s ``tail_counts``)."""
        if dev_bound >= max(len(buf) - self.k, 0):
            return np.zeros((self.scan_patterns.num_patterns,), dtype=np.int64)
        return self.suffix_counts(buf[dev_bound:])

    def suffix_counts(self, suffix: np.ndarray) -> np.ndarray:
        """Per scan pattern, the windows of a corpus's suffix, EOF truncation
        at the suffix's end (the part of :meth:`tail_counts` that reads no
        more than the suffix: ``count_multihost`` reads it from the file)."""
        from ..utils import native

        out = np.zeros((self.scan_patterns.num_patterns,), dtype=np.int64)
        nw = max(0, len(suffix) - self.k)
        for i, raw in enumerate(self.scan_patterns.raw):
            out[i] = native.banded_count(
                suffix, np.frombuffer(raw, np.uint8), self.k, nw, len(suffix)
            )
        return out

    def block_windows_for(self, n: int) -> int:
        """Kernel block width: explicit config or the planner's choice."""
        if self.config.block_windows is not None:
            return self.config.block_windows
        from ..parallel.plan import choose_block_windows

        return choose_block_windows(
            max(n - self.k, 0),
            self.m_max,
            self.scan_patterns.num_patterns,
            self.k,
        )

    def _routes(self, plan):
        """Which kernel runs each part of a scan: ``(corr, fp1)``.

        Decided once per scan from apm's plan, as apm's ``_count_pallas``
        decides. ``corr`` is the route of the k = 0 correlation set
        ``plan.plens_corr`` (:meth:`_corr_route`; None without one).
        ``fp1`` is the route of filtration phase 1 when the plan runs it as
        a correlation (``plan.fp1_conv``): "fused", the fused piece scan
        (kernel #7), under ``corr_impl="fused"`` where apm's gate
        ``fused_pieces_ok`` holds, else "conv", the piece conv, as apm's
        ``_fp1_call`` (None otherwise: kernel D runs phase 1).
        ``plan.plens_dp`` goes to the banded DP. Routes, not fallbacks on
        failure: a kernel that fails to build or launch raises.
        """
        from ..ops.corr_fused import fused_pieces_ok

        corr = self._corr_route(plan.wf, plan.halo) if plan.use_corr else None
        fp1 = None
        if plan.fp1_conv:
            fused = self.config.corr_impl == "fused" and fused_pieces_ok(
                self.m_max, plan.wf, plan.halo
            )
            fp1 = "fused" if fused else "conv"
        return corr, fp1

    def _corr_route(self, wf: int, halo: int) -> str:
        """Route of a k = 0 correlation set (``count`` and ``count_batch``),
        ``apm``'s ``_use_fused_corr``: "fused" (kernel B, or its batch mode)
        where ``apm``'s fused gate holds, unless ``corr_impl="conv"``; else
        "conv" (``apm``'s XLA conv: ``scan_corr_mxu`` or
        ``scan_corr_batch``, here ``conv1d``), or a ``ValueError`` under
        ``corr_impl="fused"``, as in ``apm``."""
        from ..ops.corr_fused import fused_eligible

        impl = self.config.corr_impl
        if impl == "conv":
            return "conv"
        if fused_eligible(self.m_max, wf, halo):
            return "fused"
        if impl == "fused":
            raise ValueError(
                "corr_impl='fused' requires m_max <= 97 and 128-aligned "
                "staging (apm_torch.ops.corr_fused.fused_eligible)"
            )
        return "conv"

    def _peq_for(self, plens: tuple) -> Optional[torch.Tensor]:
        """The device PEQ table when a DP scan of ``plens`` runs in Myers
        mode, else None."""
        from ..ops.dp_kernel import _myers_mode

        on = _myers_mode(
            self.k, self._dp_alphabet(), "int32", self.config.dp_impl,
            len(plens), self.m_max,
        )
        return self._device_peq() if on else None

    def _scan_dp(
        self, rows: torch.Tensor, bound, start: int, plens: tuple, *, wf: int, halo: int
    ) -> torch.Tensor:
        """``(p_pad,)`` int32 banded-DP counts of ``plens`` over staged
        rows: kernel C (Myers mode) or kernel A as ``apm``'s mode dispatch
        decides, or their plain versions under ``backend="torch"``."""
        from ..ops import dp_kernel

        return dp_kernel.scan_folded_dp(
            rows, self._device_tables(fused_needed=False)["pat"], bound, start,
            k=self.k, m_max=self.m_max, wf=wf, halo=halo,
            plens=plens, alphabet=self._dp_alphabet(),
            dp_impl=self.config.dp_impl, peq=self._peq_for(plens),
            plain=self.backend == "torch",
        )

    def _stage(
        self, buf: np.ndarray, c0: int, n_rows: int, wf: int, halo: int, spans=OFF,
        key=None,
    ):
        """Fold one chunk on the host and copy it to the device. On a CUDA
        device the rows go through page-locked memory and an asynchronous
        copy on the current stream (the caching host allocator keeps the
        buffer until the copy has run). ``spans`` times the two steps as
        ``fold`` and ``copy``. With a shared fold cache (a pattern-shard
        sub-scanner) and a content ``key``, the folded rows of one group
        serve every other group (``apm``'s ``_fold_cache``)."""
        fc = self._fold_cache if key is not None else None
        with self._fold_cache_lock if fc is not None else contextlib.nullcontext():
            # the lock is held over the fold: a group that asks for the
            # same chunk meanwhile waits for it instead of folding it again
            host = fc.get(key) if fc is not None else None
            if host is None:
                with spans.host("fold"):
                    host = self._host_rows(n_rows, wf + halo)
                    fold_corpus(buf, c0, n_rows, wf, halo, out=host.numpy())
                if fc is not None:
                    fc[key] = host
                    while len(fc) > 4:  # host memory: about four chunks
                        fc.pop(next(iter(fc)))
        with spans.device("copy"):
            return self._to_device(host)

    def _host_rows(self, n_rows: int, width: int) -> torch.Tensor:
        """Host staging rows, page-locked on a CUDA device."""
        pin = self.device.type == "cuda"
        return torch.empty((n_rows, width), dtype=torch.uint8, pin_memory=pin)

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """Copy host rows or vectors to the device: asynchronous on the
        current stream on a CUDA device (the caching host allocator keeps a
        page-locked buffer until the copy has run)."""
        return host.to(self.device, non_blocking=self.device.type == "cuda")

    # -- device corpus cache (apm's _staged_rows and its key) -----------------

    @staticmethod
    def _immutable(buf) -> bool:
        """True when no NumPy handle can change ``buf``'s bytes: every
        ndarray in its base chain is read-only (a read-only view of a
        writable array does not qualify: writes through the base would
        change the bytes under the view)."""
        obj = buf
        while isinstance(obj, np.ndarray):
            if obj.flags.writeable:
                return False
            obj = obj.base
        return True

    def _corpus_fp(self, buf: np.ndarray):
        """The corpus's key in the device cache (None with ``cache_corpus``
        off), memoized for immutable buffers.

        A buffer that :meth:`_immutable` proves read-only (``count_file``'s
        read-only memmap, ``np.frombuffer`` of ``bytes``, or any array the
        caller froze with ``setflags(write=False)``) is hashed once and its
        key memoized by object identity; a weak reference drops the entry
        when the array dies, so a recycled ``id`` never aliases another
        array. A writable buffer is hashed in full on every call, so an
        in-place change always changes its key.

        Contract (``apm``'s): freezing a buffer promises it never changes
        again. Thawing a scanned frozen buffer, changing it in place and
        freezing it again is not supported: the memo checks a hit against
        a sample of the bytes (:meth:`_fp_sample`), which catches a swapped
        or re-sliced buffer and bulk overwrites but not every local change,
        and a missed change serves the old content's counts. Use a new
        array, or leave the buffer writable and pay the hash every call.
        """
        if not self.config.cache_corpus:
            return None
        if not (isinstance(buf, np.ndarray) and self._immutable(buf)):
            return self._fingerprint(buf)
        key = id(buf)
        ent = self._fp_memo.get(key)
        if ent is not None and ent[0]() is buf and ent[2] == self._fp_sample(buf):
            return ent[1]
        fp = self._fingerprint(buf)
        # the callback holds the memo, not the Scanner, so a Scanner that
        # memoized a key is still freed as soon as it is dropped
        memo = self._fp_memo
        ref = weakref.ref(buf, lambda _, key=key: memo.pop(key, None))
        memo[key] = (ref, fp, self._fp_sample(buf))
        return fp

    @staticmethod
    def _fp_sample(buf: np.ndarray) -> tuple:
        """A cheap content sample that validates memo hits: the length and
        64 bytes at each of 33 evenly spaced offsets (about 2 KB, no full
        pass)."""
        n = buf.size
        if n == 0:
            return (0,)
        flat = buf.reshape(-1)
        return (n,) + tuple(
            flat[(n - 1) * i // 32 : (n - 1) * i // 32 + 64].tobytes() for i in range(33)
        )

    @staticmethod
    def _fingerprint(buf: np.ndarray) -> tuple:
        """``(length, 64-bit hash of every byte)``: the native parallel
        MurmurHash64A pass (:func:`apm_torch.utils.native.hash_bytes`), so
        any change of content, a single byte included, changes the key."""
        from ..utils import native

        return (len(buf), native.hash_bytes(buf))

    def _cache_byte_budget(self) -> int:
        """Byte cap of the device cache: ``config.cache_bytes``, else a
        quarter of the card's memory on a CUDA device, else 4 GB."""
        if self.config.cache_bytes is not None:
            return self.config.cache_bytes
        if self.device.type == "cuda":
            return torch.cuda.mem_get_info(self.device)[1] // 4
        return 4 << 30

    def _staged_rows(
        self, buf: np.ndarray, fp, c0: int, n_rows: int, wf: int, halo: int,
        spans=OFF,
    ) -> torch.Tensor:
        """One chunk's staged rows on the device: from the cache on a hit
        (no fold, no copy), else folded and copied (:meth:`_stage`) and,
        with a key ``fp``, kept. Least recently used entries go first once
        the cache passes its byte budget; an evicted tensor stays alive
        while a launch of the running call still holds it."""
        key = (fp, wf, halo, n_rows, c0)
        if fp is not None:
            with self._dev_cache_lock:
                rows = self._dev_cache.pop(key, None)
                if rows is not None:
                    self._dev_cache[key] = rows  # now the most recent
                    return rows
        rows = self._stage(buf, c0, n_rows, wf, halo, spans, key if fp is not None else None)
        if fp is not None:
            budget = self._cache_byte_budget()
            if rows.numel() <= budget:
                with self._dev_cache_lock:
                    self._dev_cache[key] = rows
                    total = sum(v.numel() for v in self._dev_cache.values())
                    while total > budget and len(self._dev_cache) > 1:
                        total -= self._dev_cache.pop(next(iter(self._dev_cache))).numel()
        return rows

    def _count_setup(self, plan, chunk_win: Optional[int] = None,
                     max_hot: Optional[int] = None) -> dict:
        """What every chunk of a ``count`` scan of ``plan`` shares: the
        routes (:meth:`_routes`), the chunk's rows, the device tables and
        the keyword arguments of the filtration calls. The sharded scans
        pass their own ``chunk_win`` (a multiple of ``plan.w``) and
        hot-row bucket ``max_hot``."""
        from ..ops import fused
        from ..ops.corr_engine import _group_rows

        corr, fp1 = self._routes(plan)
        if chunk_win is None:
            chunk_win = max(
                plan.w,
                round_up(min(self.config.chunk_bytes, plan.dev_bound), plan.w),
            )
        n_rows = chunk_win // plan.wf
        if max_hot is None:
            max_hot = fused.pick_max_hot(n_rows, plan.wf, plan.plens_filter, self.k)
        plain = self.backend == "torch"
        common = dict(
            k=self.k, m_max=self.m_max, wf=plan.wf, halo=plan.halo,
            plens=plan.plens_filter, max_hot=max_hot,
            alphabet=self._dp_alphabet(), dp_impl=self.config.dp_impl, plain=plain,
        )
        if plan.any_filter and self.k >= 1:
            common["peq"] = self._peq_for(plan.plens_filter)
        return dict(
            plan=plan, corr=corr, fp1=fp1, chunk_win=chunk_win, n_rows=n_rows,
            g_rows=_group_rows(plan.wf + plan.halo, len(self._alph), n_rows),
            max_hot=max_hot, plain=plain, common=common,
            tabs=self._device_tables(fused_needed=corr == "fused"),
            conv=self._device_corr_conv() if corr == "conv" else None,
        )

    def _launch_chunk(self, st: dict, drows: torch.Tensor, c0: int, spans=OFF,
                      bound: Optional[int] = None):
        """Launch every kernel of one staged chunk without synchronising
        (the loop body of ``apm``'s ``_count_pallas``). Returns ``(handles,
        raw)``: the ``(p_pad,)`` device counts, and for a k >= 1
        filtration chunk ``(c0, packed, rowmap, drows)``, else None.
        ``bound`` (default ``plan.dev_bound``) is the exclusive bound of the
        window starts the chunk owns: a shard's chunks stop at its end."""
        from ..ops import corr_engine, corr_fused, filter_kernel, fused

        plan, k, tabs, common = st["plan"], self.k, st["tabs"], st["common"]
        wf, halo = plan.wf, plan.halo
        dev_bound = plan.dev_bound if bound is None else bound
        p_pad, n_rows = self._pat.shape[0], st["n_rows"]
        handles = []
        if st["corr"] == "fused":
            corr_fn = corr_fused.scan_corr_fused_ref if st["plain"] else corr_fused.scan_corr_fused
            with spans.device("corr"):
                handles.append(corr_fn(
                    drows, tabs["fused"], dev_bound, c0,
                    wf=wf, halo=halo, n_rows=n_rows, p_out=p_pad,
                ))
        elif st["corr"] == "conv":
            ckern, cthr, cstride = st["conv"]
            with spans.device("corr"):
                handles.append(corr_engine.scan_corr_mxu(
                    drows, ckern, cthr, tabs["alph"], dev_bound, c0,
                    wf=wf, m_max=self.m_max, n_rows=n_rows, g_rows=st["g_rows"],
                    stride=cstride, p_out=p_pad,
                ))
        if plan.any_dp:
            with spans.device("dp"):
                handles.append(
                    self._scan_dp(drows, dev_bound, c0, plan.plens_dp, wf=wf, halo=halo)
                )
        if not plan.any_filter:
            return handles, None
        if k == 0:  # candidates are exact matches
            with spans.device("phase 1"):
                fcnt, _ = filter_kernel.scan_filter(
                    drows, tabs["pat_raw"], dev_bound, c0, k=0, m_max=self.m_max,
                    wf=wf, halo=halo, plens=plan.plens_filter, plain=st["plain"],
                )
            handles.append(fcnt)
            return handles, None
        if st["fp1"] == "fused":
            packed, rowmap = fused.filter_verify_chunk_fused(
                drows, self._device_fp1_fused(plan.plens_filter), tabs["pat"],
                dev_bound, c0, n_rows=n_rows, spans=spans, **common,
            )
        elif st["fp1"] == "conv":
            pkern, pthr, owner, stride = self._device_fp1(plan.plens_filter)
            packed, rowmap = fused.filter_verify_chunk_conv(
                drows, pkern, pthr, owner, tabs["alph"], tabs["pat"],
                dev_bound, c0, w_kern=pkern.shape[0], n_rows=n_rows,
                g_rows=st["g_rows"], fp1_stride=stride, spans=spans, **common,
            )
        else:
            packed, rowmap = fused.filter_verify_chunk(
                drows, tabs["pat_raw"], tabs["pat"], dev_bound, c0,
                spans=spans, **common,
            )
        return handles, (c0, packed, rowmap, drows)

    def _count_hot_batch(self, st: dict, drows, rowmap, c0: int, b: int):
        """Overflow recovery's batch ``b`` of one chunk on the device
        (:func:`apm_torch.ops.fused.count_hot_batch`)."""
        from ..ops import fused

        common = {key: v for key, v in st["common"].items() if key != "max_hot"}
        return fused.count_hot_batch(
            drows, rowmap, st["tabs"]["pat"], st["plan"].dev_bound, c0, b,
            n_batch=fused.OVERFLOW_BATCH, cap=fused.OVERFLOW_CAP, **common,
        )

    def _count_device(self, buf: np.ndarray, n: int, fp=_UNSET) -> np.ndarray:
        """Chunked single-device scan (port of ``apm``'s ``_count_pallas``);
        ``(p_pad,)`` int64 counts per scan pattern slot, EOF tail included.
        ``fp``: the corpus's cache key when the caller has it (the
        pattern-shard sub-scanners share their parent's).

        Each chunk's staged rows come from the device corpus cache
        (:meth:`_staged_rows`, keyed by :meth:`_corpus_fp`), or are folded
        and copied on a miss. Per chunk, every kernel is launched without
        synchronising (:meth:`_launch_chunk`): the k = 0 correlation
        (``plan.use_corr``: kernel B or the conv), the banded DP
        (``plan.plens_dp``) and filtration (``plan.plens_filter``: kernel
        D's exact counts at k = 0; at k >= 1 phase 1 through the fused
        piece scan or the piece conv (``plan.fp1_conv``) or kernel D, then
        phase 2 on the device; :meth:`_routes`). All per-chunk vectors come
        back in one fetch; then the filtration decision tree
        (:func:`apm_torch.models.pipeline.finalize_filtration`) and the EOF
        tail run on the host. The density rescan reads the rows the first
        pass staged: no chunk is staged twice in one call.

        With ``self.meter.trace`` on, the scan leaves its per-phase times
        in ``self.meter.last_spans`` (:class:`Spans`): host
        ``fingerprint``, host ``fold`` and device ``copy`` (on cache misses
        only), ``corr``, ``dp``, ``phase 1``, ``phase 2``, host ``fetch``,
        ``finalize`` (which holds the device ``count_hot_batch`` and the
        ``rescan dp``) and host ``EOF tail``.
        """
        from ..ops import fused
        from .pipeline import FilterChunk, buf_reader, finalize_filtration, make_plan

        plan = make_plan(self, n)
        wf, halo, dev_bound = plan.wf, plan.halo, plan.dev_bound
        self.last_filtration = None
        p_pad = self._pat.shape[0]
        counts = np.zeros((p_pad,), dtype=np.int64)
        n_scan = self.scan_patterns.num_patterns
        if dev_bound <= 0:
            counts[:n_scan] += self.tail_counts(buf, dev_bound)
            return counts

        spans = Spans(self.device, self.meter.trace)
        st = self._count_setup(plan)
        if fp is _UNSET:
            with spans.host("fingerprint"):
                fp = self._corpus_fp(buf)
        handles = []  # (p_pad,) int32 device counts, fetched after the loop
        raw_chunks = []  # (c0, packed, rowmap, rows) of filtration chunks
        for c0 in range(0, dev_bound, st["chunk_win"]):
            drows = self._staged_rows(buf, fp, c0, st["n_rows"], wf, halo, spans)
            got, raw = self._launch_chunk(st, drows, c0, spans)
            handles += got
            if raw is not None:
                raw_chunks.append(raw)

        # ONE device-to-host fetch for all per-chunk vectors.
        small = handles + [pk for _, pk, _, _ in raw_chunks]
        with spans.host("fetch"):
            fetched = (
                torch.cat([s.reshape(-1) for s in small]).cpu().numpy().astype(np.int64)
                if small else np.zeros((0,), np.int64)
            )
        off = 0
        for _ in handles:
            counts += fetched[off : off + p_pad]
            off += p_pad

        def make_verify_dev(drows, rowmap, c0):
            """Overflow recovery of one chunk on the device: count_hot_batch
            handles over all its full hot rows, or None past the cap."""

            def verify(n_hot: int):
                if n_hot > fused.OVERFLOW_CAP:
                    return None
                with spans.device("count_hot_batch"):
                    return [
                        self._count_hot_batch(st, drows, rowmap, c0, b)
                        for b in range(-(-n_hot // fused.OVERFLOW_BATCH))
                    ]

            return verify

        fchunks = []
        for c0, pk, rowmap, drows in raw_chunks:
            fcnt, vcnt, n_hot, clip = fused.unpack_chunk(fetched[off : off + pk.numel()], p_pad)
            off += pk.numel()
            fchunks.append(
                FilterChunk(c0, fcnt, vcnt, n_hot, clip, rowmap,
                            verify_dev=make_verify_dev(drows, rowmap, c0))
            )

        if fchunks:

            def rescan() -> np.ndarray:
                # every chunk of a k >= 1 filtration scan is in raw_chunks,
                # its rows still on the device: nothing is staged again
                parts = []
                for c0, _, _, drows in raw_chunks:
                    with spans.device("rescan dp"):
                        parts.append(self._scan_dp(
                            drows, dev_bound, c0, plan.plens_filter, wf=wf, halo=halo,
                        ))
                return torch.stack(parts).cpu().numpy().astype(np.int64).sum(axis=0)

            with spans.host("finalize"):
                counts += finalize_filtration(
                    self, buf_reader(buf), plan, n, fchunks, rescan, max_hot=st["max_hot"]
                )
        with spans.host("EOF tail"):
            counts[:n_scan] += self.tail_counts(buf, dev_bound)
        if spans.enabled:
            self.meter.last_spans = spans.totals()
        return counts

    # -- distribution (apm's count dispatch and its sub-scanners) ------------

    def devices(self) -> List[torch.device]:
        """The devices a sharded ``count`` spreads over: on a CUDA device
        the visible cards ``cuda:0 ... cuda:{n-1}``, capped by
        ``config.max_devices``; on the CPU ``max_devices`` logical devices,
        all the CPU (one by default), as ``apm``'s tests force several host
        devices onto one CPU."""
        if self.device.type == "cuda":
            n = torch.cuda.device_count()
            if self.config.max_devices is not None:
                n = min(n, self.config.max_devices)
            return [torch.device("cuda", i) for i in range(n)]
        return [self.device] * max(1, self.config.max_devices or 1)

    def _sub_config(self, device: torch.device, **kw) -> ApmConfig:
        """This scanner's config for a sub-scanner on ``device``: one device,
        no prewarm thread."""
        from dataclasses import replace

        return replace(self.config, device=str(device), strategy="single",
                       max_devices=None, prewarm_bytes=None, **kw)

    def _replicas(self, devices: Sequence[torch.device]) -> Dict[torch.device, "Scanner"]:
        """One Scanner per distinct device of ``devices`` over this
        scanner's patterns and tables (:meth:`tables` / :meth:`load_tables`,
        so tables loaded from ``apm`` carry across), cached; this scanner
        serves its own device."""
        out = {}
        for dev in devices:
            dev = _concrete(dev)
            if dev in out:
                continue
            if dev == _concrete(self.device):
                out[dev] = self
                continue
            rep = self._replica_scanners.get(dev)
            if rep is None:
                rep = Scanner(list(self.patterns.raw), self.k, self._sub_config(dev))
                rep.load_tables(self.tables())
                self._replica_scanners[dev] = rep
            out[dev] = rep
        return out

    def _pattern_shard_scanners(
        self, groups: Sequence[Sequence[int]], devices: Sequence[torch.device],
        block_windows: Optional[int] = None,
    ) -> List["Scanner"]:
        """Sub-scanners over pattern index groups, group ``d`` on
        ``devices[d]`` (``patterns_over_devices``), cached per layout so a
        repeated ``count`` reuses their device caches. ``block_windows``
        pins every group to one block width, so their staging layouts agree
        and one shared host fold serves them all (``apm``'s
        ``_pattern_shard_scanners``)."""
        key = (tuple(tuple(g) for g in groups), tuple(_concrete(d) for d in devices),
               block_windows)
        if self._shard_scanners_key == key:
            return self._shard_scanners
        subs = [
            Scanner(
                [self.scan_patterns.raw[i] for i in g], self.k,
                self._sub_config(dev, dedup_patterns=False,
                                 block_windows=block_windows or self.config.block_windows),
            )
            for g, dev in zip(groups, devices)
        ]
        fold_cache: Dict[tuple, torch.Tensor] = {}
        for sub in subs:
            sub._fold_cache = fold_cache
            sub._fold_cache_lock = self._fold_cache_lock
        self._shard_scanners_key, self._shard_scanners = key, subs
        return subs

    def _resolve_strategy(self, n: int, n_dev: int) -> str:
        """``config.strategy``, with "auto" resolved as ``apm`` resolves it
        (:func:`apm_torch.parallel.plan.choose_strategy`; the k = 0
        correlation engine is flat in P, so a scan it takes stays on the
        window axis)."""
        strategy = self.config.strategy
        if strategy != "auto":
            return strategy
        from ..parallel.plan import choose_strategy
        from .pipeline import make_plan

        flat_p = self.k == 0 and make_plan(self, n).use_corr
        return choose_strategy(
            n, self.m_max, self.scan_patterns.num_patterns, self.k, n_dev,
            flat_p_engine=flat_p,
        )

    # -- public API -----------------------------------------------------------

    def count(self, corpus: Bytes) -> np.ndarray:
        """Per-pattern match counts (int64, length = number of patterns).

        Runs on one device, or sharded over :meth:`devices` where the
        resolved strategy (:meth:`_resolve_strategy`) is
        ``database_over_devices`` or ``patterns_over_devices`` and there is
        more than one device (:func:`apm_torch.parallel.count_distributed`).
        ``last_strategy`` names the strategy resolved."""
        buf = as_u8(corpus)
        n = len(buf)
        p = self.patterns.num_patterns
        t0 = time.perf_counter()
        if n - self.k <= 0:
            self.last_duration = time.perf_counter() - t0
            return np.zeros((p,), dtype=np.int64)

        devices = self.devices()
        strategy = self._resolve_strategy(n, len(devices))
        if strategy == "single" or len(devices) == 1:
            counts = self._count_device(buf, n)
        else:
            from ..parallel.strategies import count_distributed

            counts = count_distributed(self, buf, strategy, devices)
        uniq = counts[: self.scan_patterns.num_patterns]
        expanded = uniq[self._inverse]
        self.last_duration = time.perf_counter() - t0
        self.last_strategy = strategy

        from ..utils.profiling import ScanStats, info

        stats = ScanStats(
            corpus_bytes=n,
            patterns=p,
            unique_patterns=self.scan_patterns.num_patterns,
            k=self.k,
            strategy=strategy,
            backend=self.backend,
            block_windows=self.block_windows_for(n),
            seconds=self.last_duration,
        )
        self.meter.record(stats)
        if self.config.verbose:
            info(stats.line())
        return expanded

    def count_file(self, path) -> np.ndarray:
        """Counts of a corpus file, equal to ``count(read_input_file(path))``.

        The file is mapped read-only (``np.memmap``), so the scan reads its
        pages as the native fold copies them, and its fingerprint is
        memoized for as long as the mapping lives (:meth:`_corpus_fp`).
        """
        import os

        return self.count(np.memmap(os.fspath(path), dtype=np.uint8, mode="r"))

    def count_stream(self, chunks, *, segment_bytes: Optional[int] = None) -> np.ndarray:
        """Counts of a corpus delivered in pieces, equal to
        ``count(b"".join(chunks))``, the EOF truncation applied at the true
        end of the stream only.

        ``chunks`` is any iterable of byte pieces. At most one segment
        (``segment_bytes``, default ``config.chunk_bytes``, at least
        ``4 * (m_max + k)``) plus the carry is held at a time. For a
        working buffer ``B`` a mid-stream segment owns windows ``[0, hi)``,
        ``hi = device_window_bound(len(B))``, all untruncated and below the
        final bound, and ``counts[0, hi) == count(B) - count(B[hi:])``: both
        calls count the same trailing windows with the same truncation, so
        their wrong mid-stream tails cancel exactly. ``B[hi:]`` is carried
        into the next segment.

        Segments are scanned once, so they go through a sibling Scanner
        with the device cache and prewarm off: they never evict the
        corpora that ``count`` serves from device memory.
        """
        total = np.zeros((self.patterns.num_patterns,), dtype=np.int64)
        seg = int(segment_bytes or self.config.chunk_bytes)
        seg = max(seg, 4 * max(self.m_max + self.k, 1))
        count = self.count
        if self.config.cache_corpus:
            if self._stream_scanner is None:
                from dataclasses import replace

                self._stream_scanner = Scanner(
                    list(self.patterns.raw), self.k,
                    replace(self.config, cache_corpus=False, prewarm_bytes=None),
                )
            count = self._stream_scanner.count
        parts, pending = [], 0  # buffered pieces, one concatenation a segment
        for chunk in chunks:
            b = as_u8(chunk)
            if len(b) == 0:
                continue
            parts.append(b)
            pending += len(b)
            while pending >= seg:
                carry = np.concatenate(parts) if len(parts) > 1 else parts[0]
                hi = self.device_window_bound(len(carry))
                if hi <= 0:
                    parts, pending = [carry], len(carry)
                    break
                total += count(carry)
                total -= count(carry[hi:])
                parts, pending = [carry[hi:]], len(carry) - hi
        if pending:
            total += count(np.concatenate(parts) if len(parts) > 1 else parts[0])
        return total

    def count_batch(self, corpora: Sequence[Bytes]) -> np.ndarray:
        """Counts of many corpora: ``(B, P)`` int64, exactly
        ``np.stack([count(c) for c in corpora])`` (port of ``apm``'s
        ``Scanner.count_batch``).

        Every corpus's device-owned windows are cut into blocks of ``w = 8
        * wf`` windows in a shared staging space; a block's 8 staged rows
        are folded from its own corpus only (the halo of a corpus's last
        block is that corpus's zero padding) and carry the corpus's window
        bound and the block's start. Each group of ``gmax`` blocks (from
        ``config.batch_blocks`` and ``chunk_bytes``, a power of two) is one
        staging copy and one launch: at k = 0 the batch mode of the fused
        correlation kernel (per-row limits) where ``apm``'s fused gate
        takes the set, or the batched conv (``apm``'s ``scan_corr_batch``)
        where ``apm`` runs it (:meth:`_corr_route`), else the batch mode of
        the banded DP (kernel A or C). Every group is dispatched, then the
        EOF tails are counted on the host by the native verifier while the
        device works, then all per-block counts come back in one fetch.
        Filtration stays out and the corpora are staged without the device
        cache, as in ``apm``. Under ``backend="torch"`` the same layout runs
        on the plain versions. With ``self.meter.trace`` on, the call's
        spans land in ``self.meter.last_spans``: host ``fold``, device
        ``copy``, the route's device span (``corr batch``, ``conv batch``
        or ``dp batch``), host ``EOF tail`` and host ``fetch``; the device
        spans run under the host's, which queue them asynchronously.
        """
        from ..ops import corr_engine, corr_fused, dp_kernel
        from ..ops.corr_engine import ALPHABET_MAX, M_MAX_CORR, _group_rows, corr_eligible
        from .pipeline import _FOLD, check_dp_dtype

        t0 = time.perf_counter()
        bufs = [as_u8(c) for c in corpora]
        n_batch = len(bufs)
        out = np.zeros((n_batch, self.patterns.num_patterns), dtype=np.int64)
        if n_batch == 0:
            return out
        check_dp_dtype(self.config.dp_dtype)
        k, fold, engine = self.k, _FOLD, self.config.engine
        w = round_up(self.block_windows_for(max(len(b) for b in bufs)), fold * 128)
        wf = w // fold
        halo = round_up(self.m_max + 2 * k, 128)
        p_pad = self._pat.shape[0]
        n_scan = self.scan_patterns.num_patterns

        # (corpus, block, bound) work items in a shared staging space.
        items, bounds = [], []
        for b, buf in enumerate(bufs):
            db = self.device_window_bound(len(buf))
            bounds.append(db)
            items.extend((b, blk, db) for blk in range(-(-db // w) if db > 0 else 0))

        use_corr = (
            k == 0
            and engine in ("auto", "corr")
            and corr_eligible(
                self._plens_static, len(self._corr_alphabet()), self.m_max, 0,
                auto=engine == "auto",
            )
        )
        if engine == "corr" and not use_corr:
            raise ValueError(
                "engine='corr' requires k == 0, a pattern alphabet of <= "
                f"{ALPHABET_MAX} distinct bytes, and m_max <= {M_MAX_CORR}"
            )
        uniq = np.zeros((n_batch, p_pad), dtype=np.int64)
        spans = Spans(self.device, self.meter.trace)
        if items:
            corr = self._corr_route(wf, halo) if use_corr else None
            gmax = max(8, min(
                len(items), self.config.batch_blocks or 128,
                self.config.chunk_bytes // (fold * (wf + halo)),
            ))
            # a power of two, rounded down: never past either cap
            gmax = max(8, 1 << (gmax.bit_length() - 1))
            plain = self.backend == "torch"
            tabs = self._device_tables(fused_needed=corr == "fused")
            peq = None if corr else self._peq_for(self._plens_static)
            if corr == "conv":
                ckern, cthr, cstride = self._device_corr_conv()
                g_rows = _group_rows(wf + halo, len(self._alph), gmax * fold)
            row_in_blk = np.arange(fold, dtype=np.int64) * wf
            handles = []  # (group, (gmax, p_pad) device counts)
            for g0 in range(0, len(items), gmax):
                group = items[g0 : g0 + gmax]
                with spans.host("fold"):
                    host = self._host_rows(gmax * fold, wf + halo)
                    rows_np = host.numpy()
                    meta = np.zeros((gmax, 2), dtype=np.int32)
                    limits = np.zeros((gmax * fold,), dtype=np.int32)
                    for slot, (b, blk, db) in enumerate(group):
                        sl = slice(slot * fold, (slot + 1) * fold)
                        fold_corpus(bufs[b], blk * w, fold, wf, halo, out=rows_np[sl])
                        meta[slot] = (db, blk * w)  # bound, start (per-corpus space)
                        limits[sl] = np.clip(db - blk * w - row_in_blk, 0, wf)
                    rows_np[len(group) * fold :] = 0  # padding blocks, bound 0
                with spans.device("copy"):
                    drows = self._to_device(host)
                    # limits for the k = 0 routes, [bound, start] per block else
                    dlim = self._to_device(torch.from_numpy(limits if corr else meta))
                if corr == "fused":
                    with spans.device("corr batch"):
                        cnts = corr_fused.scan_corr_batch_fused(
                            drows, tabs["fused"], dlim,
                            wf=wf, halo=halo, fold=fold, p_out=p_pad, plain=plain,
                        )
                elif corr == "conv":
                    with spans.device("conv batch"):
                        cnts = corr_engine.scan_corr_batch(
                            drows, ckern, cthr, tabs["alph"], dlim, wf=wf, fold=fold,
                            g_rows=g_rows, stride=cstride, p_out=p_pad,
                        )
                else:
                    with spans.device("dp batch"):
                        cnts = dp_kernel.scan_folded_dp_batch(
                            drows, tabs["pat"], dlim,
                            k=k, m_max=self.m_max, wf=wf, halo=halo,
                            plens=self._plens_static, alphabet=self._dp_alphabet(),
                            dp_impl=self.config.dp_impl, peq=peq, plain=plain,
                        )
                handles.append((group, cnts[:, :p_pad]))

        # the host's share, while the device runs the groups
        with spans.host("EOF tail"):
            for b, buf in enumerate(bufs):
                uniq[b, :n_scan] += self.tail_counts(buf, bounds[b])
        if items:
            # ONE device-to-host fetch for every group's counts.
            with spans.host("fetch"):
                allc = torch.stack([c for _, c in handles]).cpu().numpy()
            for gi, (group, _) in enumerate(handles):
                for slot, (b, _blk, _db) in enumerate(group):
                    uniq[b] += allc[gi, slot]
        if spans.enabled:
            self.meter.last_spans = spans.totals()
        out[:] = uniq[:, :n_scan][:, self._inverse]
        self.last_duration = time.perf_counter() - t0
        return out

    def find(self, corpus: Bytes, limit: Optional[int] = None) -> List[np.ndarray]:
        """Match positions, not just counts (port of ``apm``'s
        ``Scanner.find``).

        Returns one int64 array per input pattern: the window starts ``j``
        with ``lev(pattern, corpus[j:j+m]) <= k``, untruncated and
        EOF-truncated windows alike (the semantics of :meth:`count`).
        ``limit`` caps the positions per pattern.

        Positions are resolved on the device per chunk and path
        (:meth:`_find_device`): filtration-eligible patterns through kernel
        D, hot-row compaction and the mask mode of the DP kernels
        (``fused.find_positions_chunk``), the rest through a mask sweep of
        every row (``fused.sweep_positions_chunk``). Only the (at most one
        per chunk) row clipped by the window bound and the EOF tail run
        the host oracle. Under ``backend="torch"`` the same layout runs on
        the plain versions.
        """
        from ..ops.filter_kernel import partition_plens
        from ..utils.oracle import banded_distances
        from .pipeline import check_dp_dtype

        t0 = time.perf_counter()
        buf = as_u8(corpus)
        n = len(buf)
        k = self.k
        nw = max(n - k, 0)
        p_all = self.scan_patterns.num_patterns
        uniq_positions = [np.zeros((0,), dtype=np.int64) for _ in range(p_all)]
        self.last_find = {}
        if nw > 0:
            check_dp_dtype(self.config.dp_dtype)
            # apm's kernel path partitions as engine "filter" whatever the
            # configured engine: eligible patterns take kernel D.
            fmask, plens_filter, plens_dp = partition_plens(self._plens_static, k, "filter")
            dev_bound = self.device_window_bound(n)
            dev_positions = {pi: [] for pi in range(p_all)}
            clip_ranges = {"filter": [], "dense": []}
            if dev_bound > 0:
                self._find_device(
                    buf, n, dev_bound, fmask, plens_filter, plens_dp,
                    dev_positions, clip_ranges,
                )
            for pi, raw in enumerate(self.scan_patterns.raw):
                pat = np.frombuffer(raw, np.uint8)
                if dev_bound > 0:
                    # device positions + clipped rows + the EOF tail
                    ranges = list(clip_ranges["filter" if fmask[pi] else "dense"])
                    if dev_bound < nw:
                        ranges.append((dev_bound, nw))
                else:
                    ranges = [(0, nw)]  # corpus shorter than one window row
                found = list(dev_positions[pi])
                m = len(pat)
                for j0, j1 in ranges:
                    if j0 >= j1:
                        continue
                    # Untruncated ranges need m - 1 + k context bytes; a
                    # range reaching the EOF tail keeps the true end, so the
                    # truncation semantics apply.
                    end = n if j1 > dev_bound else min(n, j1 + m - 1 + k)
                    d = banded_distances(buf[j0:end], pat, k)
                    found.append(np.nonzero(d[: j1 - j0] <= k)[0] + j0)
                pos = (
                    np.concatenate(found).astype(np.int64)
                    if found else np.zeros((0,), dtype=np.int64)
                )
                # Segments come ascending and disjoint (chunks in order, rows
                # ascending within a chunk, clipped rows and the EOF tail
                # past all device windows), so the check is normally all the
                # sorting there is.
                if len(pos) > 1 and not np.all(pos[1:] > pos[:-1]):
                    pos = np.unique(pos)
                if limit is not None:
                    pos = pos[:limit]
                uniq_positions[pi] = pos
        self.last_duration = time.perf_counter() - t0
        return [uniq_positions[i] for i in self._inverse]

    def _find_device(
        self, buf, n, dev_bound, fmask, plens_filter, plens_dp,
        dev_positions, clip_ranges,
    ) -> None:
        """:meth:`find`'s device part: appends per-pattern position arrays
        to ``dev_positions`` and the windows of bound-clipped rows to
        ``clip_ranges`` (per path).

        Chunks are dispatched ahead of the fetches: each chunk's staged rows
        (from the device corpus cache, :meth:`_staged_rows`) go through
        every path without a host sync, and once more than
        ``4 * len(paths)`` entries are pending, the older half is flushed
        with ONE device-to-host fetch of every entry's ``(meta, pos)``. The
        bits, ``gpos``, row map and gather-batch fetches stay lazy: each
        happens only where a count read from ``meta`` asks for it.
        ``fused.FIND_BATCH`` and ``fused.POS_CAP`` are read per call.
        """
        from ..ops import fused

        find_batch, pos_cap = fused.FIND_BATCH, fused.POS_CAP
        k = self.k
        p_all = self.scan_patterns.num_patterns
        wf, halo, chunk_win, n_rows = self._find_shape(n, dev_bound)
        tabs = self._device_tables(fused_needed=False)
        dpat_raw, dpat = tabs["pat_raw"], tabs["pat"]
        kw_common = dict(
            k=k, m_max=self.m_max, wf=wf, halo=halo, p_real=p_all,
            alphabet=self._dp_alphabet(), dp_impl=self.config.dp_impl,
            peq=self._peq_for(self._plens_static), plain=self.backend == "torch",
            pos_cap=pos_cap,
        )
        paths = []
        if any(plens_filter):
            paths.append(("filter", plens_filter, fmask))
        if any(plens_dp):
            paths.append(("dense", plens_dp, tuple(m > 0 for m in plens_dp)))
        stats = {name: dict(rows=0, bits=0, gpos=0, gather=0) for name, _, _ in paths}
        self.last_find = stats

        def collect(bits_np, rows_np, c0, sel):
            """Positions from a fetched bit-packed mask."""
            for pi in range(p_all):
                if not sel[pi]:
                    continue
                m01 = fused.unpack_mask_bits(bits_np, pi, len(rows_np))
                hh, ll = np.nonzero(m01[:, :wf])
                if len(hh):
                    dev_positions[pi].append(c0 + rows_np[hh].astype(np.int64) * wf + ll)

        def collect_rows(pos2, cnts, rows_np, c0, sel):
            """Positions from per-row device compaction: ``pos2`` (nb, c)
            flat indices into (p, wf), ``cnts`` exact per-row hit counts,
            ``rows_np`` the rows' staging indices. Rows with cnt > c are
            skipped (the caller routes them through the mask)."""
            valid = (pos2 >= 0) & (cnts <= pos2.shape[1])[:, None]
            b, _ = np.nonzero(valid)
            if not len(b):
                return
            v = pos2[valid].astype(np.int64)
            pis, ll = v // wf, v % wf
            base = c0 + rows_np.astype(np.int64)[b] * wf + ll
            for pi in range(p_all):
                if sel[pi]:
                    seg = base[pis == pi]
                    if len(seg):
                        dev_positions[pi].append(seg)

        def collect_batch(name, pm, bits, rows_np, c0, sel):
            """One mask batch: per-row positions, or the packed mask when
            some row passed pos_cap (fetched only then)."""
            cnts = pm[:find_batch]
            pos2 = pm[find_batch:].reshape(find_batch, -1)
            if int(cnts.max(initial=0)) > pos2.shape[1]:
                stats[name]["bits"] += 1
                collect(bits.cpu().numpy(), rows_np, c0, sel)
            else:
                stats[name]["rows"] += 1
                rows_full = np.zeros(find_batch, dtype=np.int64)
                rows_full[: len(rows_np)] = rows_np
                collect_rows(pos2, cnts, rows_full, c0, sel)

        def gather_batches(name, hot, drows, c0, sel, kw):
            """Re-verify the full hot rows ``hot`` (ascending) in batches
            of find_batch, all dispatched before one fetch."""
            r_rows = drows.shape[0]
            batches, handles = [], []
            for b0 in range(0, len(hot), find_batch):
                batch = hot[b0 : b0 + find_batch]
                bidx = np.full(find_batch, r_rows, dtype=np.int64)
                bidx[: len(batch)] = batch
                batches.append(batch)
                handles.append(fused.gather_mask_rows(
                    drows, self._to_device(torch.from_numpy(bidx)), dpat, len(batch), **kw
                ))
            stats[name]["gather"] += len(batches)
            pms = torch.stack([pm for pm, _ in handles]).cpu().numpy()
            for batch, pm, (_, bits) in zip(batches, pms, handles):
                collect_batch(name, pm, bits, batch, c0, sel)

        def finish_path(name, plens, sel, drows, c0, mv, pos, gpos, bits, rowmap):
            kw = dict(kw_common, plens=plens)
            fcnt = mv[: len(plens)]
            n_hot = int(mv[len(plens)])
            i0 = len(plens) + 1
            idx = mv[i0 : i0 + find_batch]
            tailcnt = mv[i0 + find_batch : i0 + 2 * find_batch]
            cs0 = i0 + 2 * find_batch
            clip_starts = mv[cs0 : cs0 + fused.MAX_CLIP]
            gcnt = mv[cs0 + fused.MAX_CLIP :]  # sweep path: per-row counts
            clip_ranges[name].extend(
                (int(cs), min(int(cs) + wf, dev_bound)) for cs in clip_starts if cs >= 0
            )
            if int(fcnt.sum()) == 0:
                return
            r_rows = drows.shape[0]
            if gpos is not None and n_hot > find_batch:
                # Dense sweep: ONE gpos fetch replaces the tail verdicts and
                # every gather batch; only rows past pos_cap re-verify.
                stats[name]["gpos"] += 1
                gp = gpos.cpu().numpy()
                collect_rows(gp, gcnt, np.arange(r_rows, dtype=np.int64), c0, sel)
                over = np.nonzero(gcnt > gp.shape[1])[0]
                if len(over):
                    gather_batches(name, over, drows, c0, sel, kw)
                return
            n_first = min(n_hot, find_batch)
            if n_first > 0:
                if int(tailcnt.max(initial=0)) > pos_cap:
                    stats[name]["bits"] += 1
                    collect(bits.cpu().numpy(), idx[:n_first], c0, sel)
                else:
                    stats[name]["rows"] += 1
                    rows_full = np.zeros(find_batch, dtype=np.int64)
                    rows_full[:n_first] = idx[:n_first]
                    collect_rows(pos, tailcnt, rows_full, c0, sel)
            if n_hot > find_batch:
                rm = rowmap.cpu().numpy()
                hot = np.nonzero(rm.sum(axis=1) > 0)[0]
                full = c0 + (hot + 1) * wf <= dev_bound
                gather_batches(name, hot[full][find_batch:], drows, c0, sel, kw)

        def flush(entries):
            """ONE fetch of every entry's (meta, pos), then each entry's
            host tail."""
            if not entries:
                return
            parts = [t for e in entries for t in (e[5], e[6])]
            flat = torch.cat([t.reshape(-1).to(torch.int64) for t in parts]).cpu().numpy()
            off = 0
            for e in entries:
                mv = flat[off : off + e[5].numel()]
                off += e[5].numel()
                pos = flat[off : off + e[6].numel()].reshape(e[6].shape)
                off += e[6].numel()
                finish_path(*e[:5], mv, pos, *e[7:])

        ahead = 4 * max(1, len(paths))
        pending = []
        fp = self._corpus_fp(buf)
        for c0 in range(0, dev_bound, chunk_win):
            drows = self._staged_rows(buf, fp, c0, n_rows, wf, halo)
            for name, plens, sel in paths:
                kw = dict(kw_common, plens=plens, n_batch=find_batch)
                if name == "filter":
                    meta, pos, bits, rowmap = fused.find_positions_chunk(
                        drows, dpat_raw, dpat, dev_bound, c0, **kw
                    )
                    gpos = None
                else:
                    meta, pos, gpos, bits, rowmap = fused.sweep_positions_chunk(
                        drows, dpat, dev_bound, c0, **kw
                    )
                pending.append((name, plens, sel, drows, c0, meta, pos, gpos, bits, rowmap))
            if len(pending) > ahead:
                half = max(1, len(pending) // 2)
                flush(pending[:half])
                del pending[:half]
        flush(pending)

    def _find_shape(self, n: int, dev_bound: int) -> tuple:
        """``(wf, halo, chunk_win, n_rows)`` of :meth:`find`'s staging."""
        from ..ops.filter_kernel import FOLD

        w = round_up(self.block_windows_for(n), FOLD * 128)
        wf = w // FOLD
        chunk_win = max(w, round_up(min(self.config.chunk_bytes, dev_bound), w))
        return wf, round_up(self.m_max + 2 * self.k, 128), chunk_win, chunk_win // wf

    # -- warmup ----------------------------------------------------------------

    def warmup(
        self,
        corpus_bytes: int,
        paths: Sequence[str] = ("count", "find", "batch"),
    ) -> None:
        """Prepare the scans of a ``corpus_bytes``-byte corpus before the
        first request (``apm``'s ``Scanner.warmup``).

        Builds the host library and, under ``backend="cuda"``, the kernel
        library (each at most once a process), then drives each selected
        path once on zero rows of the exact shapes the scan will use, so
        the device tables, the caching allocator's blocks and any library
        set-up are in place too:

        * ``"count"``: every kernel of :meth:`count`'s route on one chunk of
          zero rows, and the overflow recovery's batch at k >= 1;
        * ``"find"``: :meth:`find` on a zero corpus of ``corpus_bytes``
          bytes, and one overflow gather batch (zeros never overflow);
        * ``"batch"``: :meth:`count_batch` on that zero corpus alone.

        The zero corpus's entries in the device cache are purged afterwards,
        scoped to its fingerprint: entries another call staged, and entries
        of the same fingerprint that were there before, stay. Unlike
        ``apm``'s, this warmup also runs under ``backend="torch"``, on the
        plain versions.
        """
        from ..ops import _build

        unknown = set(paths) - {"count", "find", "batch"}
        if unknown:
            raise ValueError(f"unknown warmup paths {sorted(unknown)}")
        _build.host_library()
        if self.backend == "cuda":
            _build.library()
        n = int(corpus_bytes)
        if n - self.k <= 0:
            return
        if "count" in paths:
            self._warmup_count(n)
        if "find" in paths or "batch" in paths:
            self._warmup_serving(n, paths)

    def _warmup_count(self, n: int) -> None:
        """:meth:`count`'s kernels on one chunk of zero rows (the route,
        tables and shapes of an ``n``-byte scan), then one fetch."""
        from .pipeline import make_plan

        plan = make_plan(self, n)
        if plan.dev_bound <= 0:
            return
        st = self._count_setup(plan)
        rows = torch.zeros(
            (st["n_rows"], plan.wf + plan.halo), dtype=torch.uint8, device=self.device
        )
        handles, raw = self._launch_chunk(st, rows, 0)
        if raw is not None:  # k >= 1 filtration: the overflow recovery too
            _, packed, rowmap, _ = raw
            handles += [packed, self._count_hot_batch(st, rows, rowmap, 0, 0)]
        if handles:
            torch.cat([h.reshape(-1).to(torch.int64) for h in handles]).cpu()

    def _warmup_serving(self, n: int, paths: Sequence[str]) -> None:
        """Drive :meth:`find` and :meth:`count_batch` on an ``n``-byte zero
        corpus, then purge what that staged in the device cache.

        The purge is scoped by the zero corpus's fingerprint (every cache
        key starts with it), not by a before/after diff of the keys: the
        prewarm thread runs this beside foreground scans, and a diff would
        evict what they staged meanwhile. Keys of that fingerprint present
        before the warm runs stay too (a foreground corpus of as many zero
        bytes shares the key); one staged during the warm runs is purged,
        and the foreground restages it on a miss. The zero buffer is
        writable, so nothing of it enters the fingerprint memo.
        """
        zeros = np.zeros((n,), dtype=np.uint8)
        warm_fp = self._fingerprint(zeros) if self.config.cache_corpus else None
        before = set()
        if warm_fp is not None:
            with self._dev_cache_lock:
                before = {key for key in self._dev_cache if key[0] == warm_fp}
        try:
            if "find" in paths:
                self.find(zeros)
                self._warmup_gather(n)
            if "batch" in paths:
                self.count_batch([zeros])
        finally:
            if warm_fp is not None:
                with self._dev_cache_lock:
                    for key in [
                        key for key in self._dev_cache
                        if key[0] == warm_fp and key not in before
                    ]:
                        del self._dev_cache[key]

    def _warmup_gather(self, n: int) -> None:
        """:meth:`find`'s overflow batch (``gather_mask_rows``) on zero rows
        of an ``n``-byte scan's shapes, for each path that scan runs: a
        zero corpus never overflows, so :meth:`find` alone does not reach
        it."""
        from ..ops import fused
        from ..ops.filter_kernel import partition_plens

        dev_bound = self.device_window_bound(n)
        if dev_bound <= 0:
            return
        wf, halo, _, n_rows = self._find_shape(n, dev_bound)
        rows = torch.zeros((n_rows, wf + halo), dtype=torch.uint8, device=self.device)
        idx = torch.full((fused.FIND_BATCH,), n_rows, dtype=torch.int64, device=self.device)
        dpat = self._device_tables(fused_needed=False)["pat"]
        _, plens_filter, plens_dp = partition_plens(self._plens_static, self.k, "filter")
        metas = [
            fused.gather_mask_rows(
                rows, idx, dpat, fused.FIND_BATCH,
                k=self.k, m_max=self.m_max, wf=wf, halo=halo, plens=plens,
                p_real=self.scan_patterns.num_patterns, pos_cap=fused.POS_CAP,
                alphabet=self._dp_alphabet(), dp_impl=self.config.dp_impl,
                peq=self._peq_for(self._plens_static), plain=self.backend == "torch",
            )[0]
            for plens in (plens_filter, plens_dp) if any(plens)
        ]
        if metas:
            torch.cat(metas).cpu()


def _concrete(dev) -> torch.device:
    """``dev`` with a CUDA device's index filled in (``cuda`` -> ``cuda:i``,
    the current card), so equal devices compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def scan_counts(
    corpus: Bytes,
    patterns: Sequence[Bytes],
    k: int,
    config: Optional[ApmConfig] = None,
) -> List[int]:
    """One-shot functional API mirroring the reference CLI semantics."""
    return [int(c) for c in Scanner(patterns, k, config).count(corpus)]
