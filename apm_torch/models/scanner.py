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
        self._dev_tables: Dict[str, object] = {}  # device copies

        from ..utils.profiling import Meter

        self.last_duration: Optional[float] = None
        self.last_strategy: Optional[str] = None
        self.meter = Meter()

    # -- configuration --------------------------------------------------------

    def _check_config(self) -> None:
        """Refuse, up front, the options whose engine the port lacks."""
        cfg = self.config
        if cfg.engine == "filter":
            raise NotImplementedError(
                f"engine='filter' (shift-OR filtration kernel) is {_ROADMAP} #8"
            )
        if cfg.dp_impl == "myers":
            raise NotImplementedError(
                f"dp_impl='myers' (bit-parallel band) is {_ROADMAP} #7; "
                "'auto' and 'band' run the classic band with the same counts"
            )
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

    def tables(self) -> Dict[str, np.ndarray]:
        """The scanner's tables as NumPy arrays — the keys
        :meth:`load_tables` takes. ``km``/``thr`` only when the pattern set
        fits the fused correlation tables (m_max <= 97)."""
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
        return out

    def load_tables(self, arrays: Dict[str, np.ndarray]) -> None:
        """Take the tables of an ``apm.Scanner`` over the same patterns.

        ``arrays`` holds ``pat`` (k-padded table), ``plen``, ``pat_raw``,
        ``alphabet`` and optionally ``km`` (bf16 cast to float32, or int8)
        and ``thr`` — NumPy arrays, as :meth:`tables` returns them. They
        replace this scanner's own tables and are moved to its device; a
        table whose shape or dtype does not fit this pattern set raises.
        """
        def take(name, like):
            a = np.asarray(arrays[name])
            if a.shape != like.shape or a.dtype != like.dtype:
                raise ValueError(
                    f"table {name!r}: {a.dtype} {a.shape}, expected "
                    f"{like.dtype} {like.shape}"
                )
            return np.ascontiguousarray(a)

        pat = take("pat", self._pat)
        plen = take("plen", self._plen)
        pat_raw = take("pat_raw", self._pat_raw)
        alph = take("alphabet", self._alph)
        fused = None
        if "km" in arrays or "thr" in arrays:
            km = np.asarray(arrays["km"])
            if km.dtype != np.int8:
                km = km.astype(np.float32)
            thr = np.asarray(arrays["thr"])
            fused = (np.ascontiguousarray(km), np.ascontiguousarray(thr))
        self._pat, self._plen, self._pat_raw, self._alph = pat, plen, pat_raw, alph
        self._plens_static = tuple(int(x) for x in plen)
        self._fused_np = fused
        self._dev_tables = {}
        self._device_tables(fused_needed=fused is not None)

    def _device_tables(self, fused_needed: bool) -> Dict[str, object]:
        """Device copies of the tables (made once)."""
        t = self._dev_tables
        if "pat" not in t:
            t["pat"] = torch.from_numpy(self._pat).to(self.device)
        if fused_needed and "fused" not in t:
            from ..ops.corr_fused import FusedTables, pick_s

            km, thr = self._corr_fused_tables()
            t["fused"] = FusedTables.from_numpy(
                km, thr, self._alph, pick_s(self.m_max), self.device
            )
        return t

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

        Decided once per scan from apm's plan. The correlation kernel takes
        the plan's correlation set when apm's fused gate admits it. Every
        other pattern goes to the banded-DP kernel, which counts exactly at
        every k — including, until their kernels are ported, the patterns
        apm sends to its filtration kernels (``plan.plens_filter``) and the
        k = 0 sets apm sends to its XLA conv (97 < m_max <= 512 under
        ``engine='auto'``). These are routes, not fallbacks on failure.
        """
        from ..ops.corr_fused import fused_eligible

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
        plens_dp = tuple(
            max(a, b) for a, b in zip(plan.plens_dp, plan.plens_filter)
        )
        return False, plens_dp

    def _stage(self, buf: np.ndarray, c0: int, n_rows: int, wf: int, halo: int):
        """Fold one chunk on the host and copy it to the device. On a CUDA
        device the rows go through page-locked memory and an asynchronous
        copy on the current stream (the caching host allocator keeps the
        buffer until the copy has run)."""
        if self.device.type == "cuda":
            host = torch.empty((n_rows, wf + halo), dtype=torch.uint8, pin_memory=True)
            fold_corpus(buf, c0, n_rows, wf, halo, out=host.numpy())
            return host.to(self.device, non_blocking=True)
        rows = torch.from_numpy(fold_corpus(buf, c0, n_rows, wf, halo))
        return rows.to(self.device)

    def _count_device(self, buf: np.ndarray, n: int) -> np.ndarray:
        """Chunked single-device scan; ``(p_pad,)`` int64 counts per scan
        pattern slot, EOF tail included."""
        from ..ops import corr_fused, dp_kernel
        from .pipeline import make_plan

        k = self.k
        plan = make_plan(self, n)
        use_fused, plens_dp = self._routes(plan)
        wf, halo, dev_bound = plan.wf, plan.halo, plan.dev_bound
        p_pad = self._pat.shape[0]
        counts = np.zeros((p_pad,), dtype=np.int64)
        n_scan = self.scan_patterns.num_patterns
        if dev_bound <= 0:
            counts[:n_scan] += self.tail_counts(buf, dev_bound)
            return counts

        if self.backend == "cuda":
            corr_fn, dp_fn = corr_fused.scan_corr_fused, dp_kernel.scan_folded_dp
        else:
            corr_fn = corr_fused.scan_corr_fused_ref
            dp_fn = dp_kernel.scan_folded_dp_ref
        tabs = self._device_tables(fused_needed=use_fused)
        chunk_win = max(
            plan.w,
            round_up(min(self.config.chunk_bytes, dev_bound), plan.w),
        )
        n_rows = chunk_win // wf
        handles = []  # (p_pad,) int32 device counts, fetched after the loop
        for c0 in range(0, dev_bound, chunk_win):
            drows = self._stage(buf, c0, n_rows, wf, halo)
            if use_fused:
                handles.append(
                    corr_fn(
                        drows, tabs["fused"], dev_bound, c0,
                        wf=wf, halo=halo, n_rows=n_rows, p_out=p_pad,
                    )
                )
            if any(plens_dp):
                handles.append(
                    dp_fn(
                        drows, tabs["pat"], dev_bound, c0,
                        k=k, m_max=self.m_max, wf=wf, halo=halo,
                        plens=plens_dp,
                    )
                )
        # ONE device-to-host fetch for all per-chunk vectors.
        if handles:
            fetched = torch.stack(handles).cpu().numpy().astype(np.int64)
            counts += fetched.sum(axis=0)
        counts[:n_scan] += self.tail_counts(buf, dev_bound)
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
