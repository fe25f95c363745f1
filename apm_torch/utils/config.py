"""Configuration for the scan pipeline (port of ``apm/utils/config.py``).

Replaces the reference's three config tiers (compile-time ``-D`` flags,
``OMP_NUM_THREADS``, CLI positionals + trailing strategy word — SURVEY.md §5)
with one dataclass. The fields are ``apm``'s, so a config carries across;
``device`` is new. Values the port does not implement yet (more than one
device, the narrow DP dtypes) are accepted here and refused by the Scanner
with a pointer to ``ROADMAP.md``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ApmConfig:
    # Per-block scan implementation: "cuda" (the hand-written kernels in
    # apm_torch/csrc), "torch" (their plain PyTorch versions), or "auto",
    # which follows the device: kernels on a CUDA device, plain versions on
    # the CPU.
    backend: str = "auto"
    # Device the scan runs on. CPU use is opt-in (the tests use it).
    device: str = "cuda"
    # Kept for config parity with apm (its Pallas interpreter switch); the
    # port has no interpreter and ignores it.
    interpret: bool = False
    # Windows per kernel block. None = let the planner pick
    # (apm_torch.parallel.plan.choose_block_windows).
    block_windows: Optional[int] = None
    # Corpus bytes staged and copied to the device per chunk.
    chunk_bytes: int = 256 << 20
    # Distribution strategy: the port is single-device, so only "auto" and
    # "single" run; the sharded strategies raise NotImplementedError.
    strategy: str = "auto"
    # Emit per-scan timing info (reference APM_INFO analog).
    verbose: bool = False
    # Optional cap on devices used (None = all visible; the port uses one).
    max_devices: Optional[int] = None
    # Scan each distinct pattern once and expand counts to duplicates.
    dedup_patterns: bool = True
    # Scan engine, routed as apm's plan routes it: "auto" (correlation at
    # k = 0 where eligible, pigeonhole filtration for eligible patterns,
    # the banded DP for the rest), "filter" (filtration with the shift-OR
    # piece kernel, never the piece conv), "dp" (banded DP only), "corr"
    # (demands the correlation engine).
    engine: str = "auto"
    # Correlation implementation, routed as apm routes it. At k = 0: "auto"
    # runs the fused correlation kernel where its gate holds (m_max <= 97,
    # 128-aligned staging) and the bit-plane conv otherwise (m_max <= 512);
    # "fused" demands the fused kernel and raises where its gate fails;
    # "conv" always runs the conv. At k >= 1, where the plan runs
    # filtration phase 1 as a correlation: "auto" and "conv" run the piece
    # conv; "fused" runs the fused piece scan where its gate holds (m_max
    # <= 65, 128-aligned staging) and the piece conv otherwise.
    corr_impl: str = "auto"
    # DP cell dtype: only "int32" runs in the port (apm's int16/int8 are
    # interpreter-only layouts); other values raise.
    dp_dtype: str = "int32"
    # Banded-DP implementation: "auto" (the bit-parallel Myers band from
    # k = 3 where it can represent the pattern set, else the classic band),
    # "band" (always the classic band), "myers" (Myers wherever it can).
    # Both give the same counts.
    dp_impl: str = "auto"
    # Keep each chunk's staged rows on the device, keyed by a hash of the
    # corpus's content, so a repeated corpus is neither folded nor copied
    # again (Scanner._staged_rows). A writable buffer is hashed in full on
    # every call; a buffer with no writable handle (a frozen array, a
    # read-only memmap, np.frombuffer of bytes) is hashed once and its key
    # memoized by identity. Freezing is a promise the buffer never changes
    # again: thawing a scanned frozen buffer, changing it in place and
    # freezing it again may serve the old content's counts (the memo only
    # samples the bytes); use a new array or leave the buffer writable.
    cache_corpus: bool = True
    # Byte cap of that cache, least recently used chunks evicted first.
    # None = a quarter of the card's memory (4 GB off the card).
    cache_bytes: Optional[int] = None
    # If set, the Scanner runs warmup(prewarm_bytes) on a background thread
    # from its constructor; Scanner.prewarm_join() waits for it and raises
    # what it raised.
    prewarm_bytes: Optional[int] = None
    # Blocks of 8 staged rows per count_batch launch (None = 128), capped by
    # chunk_bytes and rounded down to a power of two, at least 8.
    batch_blocks: Optional[int] = None

    def validate(self) -> "ApmConfig":
        if self.backend not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.strategy not in (
            "auto",
            "single",
            "database_over_devices",
            "patterns_over_devices",
        ):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.engine not in ("auto", "dp", "filter", "corr"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.corr_impl not in ("auto", "conv", "fused"):
            raise ValueError(f"unknown corr_impl {self.corr_impl!r}")
        if self.dp_dtype not in ("int32", "int16", "int8"):
            raise ValueError(f"unknown dp_dtype {self.dp_dtype!r}")
        if self.dp_impl not in ("auto", "band", "myers"):
            raise ValueError(f"unknown dp_impl {self.dp_impl!r}")
        if self.cache_bytes is not None and self.cache_bytes < 0:
            raise ValueError("cache_bytes must be >= 0")
        if self.batch_blocks is not None and self.batch_blocks <= 0:
            raise ValueError("batch_blocks must be > 0")
        if self.prewarm_bytes is not None and self.prewarm_bytes < 0:
            raise ValueError("prewarm_bytes must be >= 0")
        if self.block_windows is not None and (
            self.block_windows % 128 != 0 or self.block_windows <= 0
        ):
            raise ValueError("block_windows must be a positive multiple of 128")
        return self
