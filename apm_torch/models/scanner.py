"""End-to-end scan pipeline on one device (port of ``apm/models/scanner.py``).

A :class:`Scanner` owns the pattern tables, plans a scan with
:func:`apm_torch.models.pipeline.make_plan` (the same plan as ``apm``),
stages the corpus into overlapping rows chunk by chunk, launches the
kernels of every chunk without synchronising, fetches all per-chunk counts
once, and adds the EOF-truncated tail windows counted on the host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.common import fold_corpus, round_up
from ..utils.config import ApmConfig
from ..utils.io import PatternSet
from ..utils.oracle import Bytes, as_u8
from ..utils.profiling import OFF, Spans

_ROADMAP = "not ported yet (ROADMAP.md, 'Queue 1')"


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
        self._fp1_np = None  # (plens_filter, (kern, thr, owner, stride))
        self._peq_np = None  # Myers-mode PEQ table, built on demand
        self._dev_tables: Dict[str, object] = {}  # device copies

        from ..utils.profiling import Meter

        self.last_duration: Optional[float] = None
        self.last_strategy: Optional[str] = None
        # The last scan's filtration outcome (pipeline.finalize_filtration):
        # route taken, full hot rows, hot-row bucket; None without phase 2.
        self.last_filtration: Optional[dict] = None
        self.meter = Meter()

    # -- configuration --------------------------------------------------------

    def _check_config(self) -> None:
        """Refuse, up front, the options whose engine the port lacks."""
        cfg = self.config
        if cfg.strategy in ("database_over_devices", "patterns_over_devices"):
            raise NotImplementedError(
                f"strategy={cfg.strategy!r} (more than one device) is "
                f"{_ROADMAP} #12"
            )
        if cfg.max_devices is not None and cfg.max_devices > 1:
            raise NotImplementedError(
                f"max_devices={cfg.max_devices}: more than one device is "
                f"{_ROADMAP} #12"
            )
        from .pipeline import check_dp_dtype

        check_dp_dtype(cfg.dp_dtype)

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
        scan runs conv phase 1; ``peq`` only when the bit-parallel band can
        represent the table."""
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
        if self._myers_table_ok():
            out["peq"] = self._peq()
        return out

    def load_tables(self, arrays: Dict[str, np.ndarray]) -> None:
        """Take the tables of an ``apm.Scanner`` over the same patterns.

        ``arrays`` holds ``pat`` (k-padded table), ``plen``, ``pat_raw``,
        ``alphabet`` and optionally ``km`` (bf16 cast to float32, or int8)
        and ``thr``, the piece tables ``pkern`` (bf16 cast to float32),
        ``pthr``, ``owner`` and ``stride``, and ``peq`` — NumPy arrays, as
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
        peq = take("peq") if "peq" in arrays else None
        self._pat, self._plen, self._pat_raw, self._alph = pat, plen, pat_raw, alph
        self._plens_static = tuple(int(x) for x in plen)
        self._fused_np, self._fp1_np, self._peq_np = fused, fp1, peq
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
        """Oracle counts for the EOF tail windows ``j in [dev_bound, n-k)``,
        per scan (deduplicated) pattern."""
        from ..utils.oracle import count_matches

        n = len(buf)
        out = np.zeros((self.scan_patterns.num_patterns,), dtype=np.int64)
        if dev_bound >= max(n - self.k, 0):
            return out
        out[:] = count_matches(buf[dev_bound:], list(self.scan_patterns.raw), self.k)
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
        """Which kernel scans which patterns: ``(fused_corr, plens_dp)``.

        Decided once per scan from apm's plan, as apm's ``_count_pallas``
        decides. The correlation kernel takes the plan's correlation set
        when apm's fused gate admits it; ``plan.plens_dp`` goes to the
        banded DP; ``plan.plens_filter`` to filtration (:meth:`_count_device`).
        One temporary route remains: the k = 0 sets apm sends to its XLA
        conv (97 < m_max <= 512 under ``engine='auto'``) go to the banded
        DP, which counts them exactly. Routes, not fallbacks on failure.
        """
        from ..ops.corr_fused import fused_eligible, fused_pieces_ok

        if plan.use_corr:
            impl = self.config.corr_impl
            if impl == "conv":
                raise NotImplementedError(
                    f"corr_impl='conv' (the XLA correlation conv) is {_ROADMAP} #5"
                )
            if fused_eligible(self.m_max, plan.wf, plan.halo):
                return True, tuple(0 for _ in plan.plens_corr)
            if impl == "fused":
                raise ValueError(
                    "corr_impl='fused' requires m_max <= 97 and 128-aligned "
                    "staging (apm_torch.ops.corr_fused.fused_eligible)"
                )
            if self.config.engine == "corr":
                raise NotImplementedError(
                    "engine='corr' with 97 < m_max <= 512 runs apm's XLA "
                    f"correlation conv, which is {_ROADMAP} #5"
                )
            return False, plan.plens_corr
        if (
            plan.fp1_conv
            and self.config.corr_impl == "fused"
            and fused_pieces_ok(self.m_max, plan.wf, plan.halo)
        ):
            raise NotImplementedError(
                "corr_impl='fused' at k >= 1 runs apm's fused piece scan "
                "(scan_pieces_fused, TPU kernel #7), which is not ported yet "
                "(ROADMAP.md, 'Queue 2' #7); corr_impl='auto' runs the piece conv"
            )
        return False, plan.plens_dp

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
            rows, self._dev_tables["pat"], bound, start,
            k=self.k, m_max=self.m_max, wf=wf, halo=halo,
            plens=plens, alphabet=self._dp_alphabet(),
            dp_impl=self.config.dp_impl, peq=self._peq_for(plens),
            plain=self.backend == "torch",
        )

    def _stage(
        self, buf: np.ndarray, c0: int, n_rows: int, wf: int, halo: int,
        spans=OFF, tag: str = "",
    ):
        """Fold one chunk on the host and copy it to the device. On a CUDA
        device the rows go through page-locked memory and an asynchronous
        copy on the current stream (the caching host allocator keeps the
        buffer until the copy has run). ``spans`` times the two steps as
        ``tag + "fold"`` and ``tag + "copy"``."""
        with spans.host(tag + "fold"):
            if self.device.type == "cuda":
                host = torch.empty((n_rows, wf + halo), dtype=torch.uint8, pin_memory=True)
                fold_corpus(buf, c0, n_rows, wf, halo, out=host.numpy())
            else:
                host = torch.from_numpy(fold_corpus(buf, c0, n_rows, wf, halo))
        with spans.device(tag + "copy"):
            return host.to(self.device, non_blocking=self.device.type == "cuda")

    def _count_device(self, buf: np.ndarray, n: int) -> np.ndarray:
        """Chunked single-device scan (port of ``apm``'s ``_count_pallas``);
        ``(p_pad,)`` int64 counts per scan pattern slot, EOF tail included.

        Per chunk, every kernel is launched without synchronising: the
        correlation kernel (``plan.use_corr``), the banded DP
        (``plan.plens_dp``) and filtration (``plan.plens_filter``: kernel
        D's exact counts at k = 0; at k >= 1 phase 1 through the piece conv
        (``plan.fp1_conv``) or kernel D, then phase 2 on the device). All
        per-chunk vectors come back in one fetch; then the filtration
        decision tree (:func:`apm_torch.models.pipeline.finalize_filtration`)
        and the EOF tail run on the host.

        With ``self.meter.trace`` on, the scan leaves its per-phase times
        in ``self.meter.last_spans`` (:class:`Spans`): host ``fold``,
        device ``copy``, ``corr``, ``dp``, ``phase 1``, ``phase 2``,
        host ``fetch``, ``finalize`` (which holds the device
        ``count_hot_batch`` and the ``rescan `` fold, copy and dp) and
        host ``EOF tail``.
        """
        from ..ops import corr_fused, filter_kernel, fused
        from ..ops.corr_engine import _group_rows
        from .pipeline import FilterChunk, buf_reader, finalize_filtration, make_plan

        k = self.k
        plan = make_plan(self, n)
        use_fused, plens_dp = self._routes(plan)
        wf, halo, dev_bound = plan.wf, plan.halo, plan.dev_bound
        self.last_filtration = None
        p_pad = self._pat.shape[0]
        counts = np.zeros((p_pad,), dtype=np.int64)
        n_scan = self.scan_patterns.num_patterns
        if dev_bound <= 0:
            counts[:n_scan] += self.tail_counts(buf, dev_bound)
            return counts

        plain = self.backend == "torch"
        spans = Spans(self.device, self.meter.trace)
        corr_fn = corr_fused.scan_corr_fused_ref if plain else corr_fused.scan_corr_fused
        tabs = self._device_tables(fused_needed=use_fused)
        chunk_win = max(
            plan.w,
            round_up(min(self.config.chunk_bytes, dev_bound), plan.w),
        )
        n_rows = chunk_win // wf
        max_hot = fused.pick_max_hot(n_rows, wf, plan.plens_filter, k)
        common = dict(
            k=k, m_max=self.m_max, wf=wf, halo=halo, plens=plan.plens_filter,
            max_hot=max_hot, alphabet=self._dp_alphabet(),
            dp_impl=self.config.dp_impl, plain=plain,
        )
        if plan.any_filter and k >= 1:
            common["peq"] = self._peq_for(plan.plens_filter)
        handles = []  # (p_pad,) int32 device counts, fetched after the loop
        raw_chunks = []  # (c0, packed, rowmap, rows) of filtration chunks
        for c0 in range(0, dev_bound, chunk_win):
            drows = self._stage(buf, c0, n_rows, wf, halo, spans)
            if use_fused:
                with spans.device("corr"):
                    handles.append(
                        corr_fn(
                            drows, tabs["fused"], dev_bound, c0,
                            wf=wf, halo=halo, n_rows=n_rows, p_out=p_pad,
                        )
                    )
            if any(plens_dp):
                with spans.device("dp"):
                    handles.append(
                        self._scan_dp(drows, dev_bound, c0, plens_dp, wf=wf, halo=halo)
                    )
            if not plan.any_filter:
                continue
            if k == 0:  # candidates are exact matches
                with spans.device("phase 1"):
                    fcnt, _ = filter_kernel.scan_filter(
                        drows, tabs["pat_raw"], dev_bound, c0, k=0, m_max=self.m_max,
                        wf=wf, halo=halo, plens=plan.plens_filter, plain=plain,
                    )
                handles.append(fcnt)
                continue
            if plan.fp1_conv:
                pkern, pthr, owner, stride = self._device_fp1(plan.plens_filter)
                packed, rowmap = fused.filter_verify_chunk_conv(
                    drows, pkern, pthr, owner, tabs["alph"], tabs["pat"],
                    dev_bound, c0, w_kern=pkern.shape[0], n_rows=n_rows,
                    g_rows=_group_rows(wf + halo, len(self._alph), n_rows),
                    fp1_stride=stride, spans=spans, **common,
                )
            else:
                packed, rowmap = fused.filter_verify_chunk(
                    drows, tabs["pat_raw"], tabs["pat"], dev_bound, c0,
                    spans=spans, **common,
                )
            raw_chunks.append((c0, packed, rowmap, drows))

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
                n_batch, cap = fused.OVERFLOW_BATCH, fused.OVERFLOW_CAP
                if n_hot > cap:
                    return None
                with spans.device("count_hot_batch"):
                    return [
                        fused.count_hot_batch(
                            drows, rowmap, tabs["pat"], dev_bound, c0, b,
                            n_batch=n_batch, cap=cap,
                            **{key: common[key] for key in common if key != "max_hot"},
                        )
                        for b in range(-(-n_hot // n_batch))
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
                parts = []
                for c0 in range(0, dev_bound, chunk_win):
                    drows = self._stage(buf, c0, n_rows, wf, halo, spans, "rescan ")
                    with spans.device("rescan dp"):
                        parts.append(self._scan_dp(
                            drows, dev_bound, c0, plan.plens_filter, wf=wf, halo=halo,
                        ))
                return torch.stack(parts).cpu().numpy().astype(np.int64).sum(axis=0)

            with spans.host("finalize"):
                counts += finalize_filtration(
                    self, buf_reader(buf), plan, n, fchunks, rescan, max_hot=max_hot
                )
        with spans.host("EOF tail"):
            counts[:n_scan] += self.tail_counts(buf, dev_bound)
        if spans.enabled:
            self.meter.last_spans = spans.totals()
        return counts

    # -- public API -----------------------------------------------------------

    def count(self, corpus: Bytes) -> np.ndarray:
        """Per-pattern match counts (int64, length = number of patterns)."""
        buf = as_u8(corpus)
        n = len(buf)
        p = self.patterns.num_patterns
        t0 = time.perf_counter()
        if n - self.k <= 0:
            self.last_duration = time.perf_counter() - t0
            return np.zeros((p,), dtype=np.int64)

        counts = self._count_device(buf, n)
        uniq = counts[: self.scan_patterns.num_patterns]
        expanded = uniq[self._inverse]
        self.last_duration = time.perf_counter() - t0
        self.last_strategy = "single"

        from ..utils.profiling import ScanStats, info

        stats = ScanStats(
            corpus_bytes=n,
            patterns=p,
            unique_patterns=self.scan_patterns.num_patterns,
            k=self.k,
            strategy="single",
            backend=self.backend,
            block_windows=self.block_windows_for(n),
            seconds=self.last_duration,
        )
        self.meter.record(stats)
        if self.config.verbose:
            info(stats.line())
        return expanded


def scan_counts(
    corpus: Bytes,
    patterns: Sequence[Bytes],
    k: int,
    config: Optional[ApmConfig] = None,
) -> List[int]:
    """One-shot functional API mirroring the reference CLI semantics."""
    return [int(c) for c in Scanner(patterns, k, config).count(corpus)]
