"""Configuration for the scan pipeline (port of ``apm/utils/config.py``).

Replaces the reference's three config tiers (compile-time ``-D`` flags,
``OMP_NUM_THREADS``, CLI positionals + trailing strategy word — SURVEY.md §5)
with one dataclass. The fields are ``apm``'s, so a config carries across;
``device`` is new. Values the port does not implement yet are accepted here
and refused by the Scanner with a pointer to ``ROADMAP.md``.
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
    # Scan engine: "auto"/"dp" run the k = 0 correlation kernel where
    # apm's plan picks the correlation engine and the banded DP kernel for
    # every other pattern; "corr" demands the correlation engine; "filter"
    # (pigeonhole filtration) is not ported yet and raises.
    engine: str = "auto"
    # k = 0 correlation implementation: "auto"/"fused" run the fused
    # correlation kernel (m_max <= 97); "conv" is not ported yet and raises.
    corr_impl: str = "auto"
    # DP cell dtype: only "int32" runs in the port (apm's int16/int8 are
    # interpreter-only layouts); other values raise.
    dp_dtype: str = "int32"
    # Banded-DP implementation: "auto" and "band" run the classic band
    # (same counts as Myers); "myers" is not ported yet and raises.
    dp_impl: str = "auto"
    # apm's serving-surface knobs, accepted for config parity; the port has
    # no device corpus cache, prewarm or count_batch yet (ROADMAP.md).
    cache_corpus: bool = True
    cache_bytes: Optional[int] = None
    prewarm_bytes: Optional[int] = None
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
