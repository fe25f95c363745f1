"""Throughput metering (port of ``apm/utils/profiling.py``).

* :class:`ScanStats` / :class:`Meter` — bytes/s throughput accounting, the
  north-star metric;
* :func:`info` — the ``APM_INFO`` analog, gated by config/env instead of a
  compile-time ``-D`` flag.

``apm``'s ``trace`` (a ``jax.profiler`` bracket) has no counterpart yet; a
``torch.profiler`` one is measurement work in ``ROADMAP.md``.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import List


def info(msg: str, *, enabled: bool = True) -> None:
    """APM_INFO analog: runtime-gated progress line on stderr."""
    if enabled or os.environ.get("APM_INFO"):
        print(f"[apm] {msg}", file=sys.stderr, flush=True)


@dataclass
class ScanStats:
    """One scan's throughput record."""

    corpus_bytes: int
    patterns: int
    unique_patterns: int
    k: int
    strategy: str
    backend: str
    block_windows: int
    seconds: float

    @property
    def mb_per_s(self) -> float:
        return self.corpus_bytes / max(self.seconds, 1e-12) / 1e6

    @property
    def gb_per_s(self) -> float:
        return self.mb_per_s / 1e3

    @property
    def cells_per_s(self) -> float:
        """DP lattice throughput: windows x patterns x pattern-length / s."""
        return (
            self.corpus_bytes
            * self.unique_patterns
            / max(self.seconds, 1e-12)
        )

    def line(self) -> str:
        return (
            f"{self.corpus_bytes} B x {self.patterns} pat "
            f"({self.unique_patterns} uniq) k={self.k} "
            f"[{self.strategy}/{self.backend} w={self.block_windows}] "
            f"in {self.seconds:.4f} s -> {self.mb_per_s:.1f} MB/s"
        )


@dataclass
class Meter:
    """Accumulates ScanStats across scans (serving-style aggregate view)."""

    history: List[ScanStats] = field(default_factory=list)

    def record(self, stats: ScanStats) -> None:
        self.history.append(stats)

    @property
    def total_bytes(self) -> int:
        return sum(s.corpus_bytes for s in self.history)

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.history)

    @property
    def aggregate_mb_per_s(self) -> float:
        return self.total_bytes / max(self.total_seconds, 1e-12) / 1e6
