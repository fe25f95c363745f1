"""Tracing, profiling and throughput metering (port of
``apm/utils/profiling.py``).

* :func:`trace` — a ``torch.profiler`` bracket around a scan that writes a
  Chrome trace (``apm``'s is a ``jax.profiler`` one), viewable in
  Perfetto or ``chrome://tracing``; :func:`profiler` is the profiler it
  opens;
* :class:`ScanStats` / :class:`Meter` — bytes/s throughput accounting, the
  north-star metric;
* :class:`Spans` — named per-phase times of one scan, recorded where the
  work is dispatched (``Meter.trace`` turns them on);
* :class:`Stopwatch` — a minimal phase timer;
* :func:`info` — the ``APM_INFO`` analog, gated by config/env instead of a
  compile-time ``-D`` flag.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List


def info(msg: str, *, enabled: bool = True) -> None:
    """APM_INFO analog: runtime-gated progress line on stderr."""
    if enabled or os.environ.get("APM_INFO"):
        print(f"[apm] {msg}", file=sys.stderr, flush=True)


def profiler(cpu: bool = True):
    """A ``torch.profiler.profile`` over the host's operators (``cpu``)
    and, when a card is present, its kernels, copies and memsets."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if cpu else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@contextmanager
def trace(log_dir: str = "/tmp/apm_trace") -> Iterator[str]:
    """Capture a ``torch.profiler`` trace around a scan.

    Usage::

        with profiling.trace("/tmp/apm_trace"):
            scanner.count(corpus)

    On exit, as ``apm``'s, the trace is written whether or not the block
    raised, to ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format); an
    exception from the block propagates."""
    import torch

    os.makedirs(log_dir, exist_ok=True)
    prof = profiler()
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


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


class Spans:
    """Named spans of one scan, in milliseconds summed per name.

    ``device(name)`` brackets work queued on the device: on a CUDA device
    two CUDA events on the current stream, so the span is the device
    timeline from the first queued piece of work to the last, launch gaps
    included; elsewhere the host clock (the work runs synchronously).
    ``host(name)`` brackets host work with the host clock. Off, a span
    costs one test. Spans may nest; each name sums its own brackets.
    """

    def __init__(self, device=None, enabled: bool = False):
        self.enabled = enabled
        self._cuda = enabled and device is not None and device.type == "cuda"
        self._events: List[tuple] = []  # (name, start event, end event)
        self._ms: Dict[str, float] = {}

    def _add(self, name: str, ms: float) -> None:
        self._ms[name] = self._ms.get(name, 0.0) + ms

    @contextmanager
    def host(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        self._add(name, (time.perf_counter() - t0) * 1e3)

    @contextmanager
    def device(self, name: str):
        if not self._cuda:
            with self.host(name):
                yield
            return
        import torch

        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        yield
        e1.record()
        self._events.append((name, e0, e1))

    def totals(self) -> Dict[str, float]:
        """Milliseconds per name; waits for the device spans' end events."""
        for name, e0, e1 in self._events:
            e1.synchronize()
            self._add(name, e0.elapsed_time(e1))
        self._events = []
        return dict(self._ms)


OFF = Spans()


@dataclass
class Meter:
    """Accumulates ScanStats across scans (serving-style aggregate view).

    With ``trace`` on, each scan also leaves its :class:`Spans` totals in
    ``last_spans``."""

    history: List[ScanStats] = field(default_factory=list)
    trace: bool = False
    last_spans: Dict[str, float] = field(default_factory=dict)

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


class Stopwatch:
    """Minimal phase timer (the gettimeofday-bracket analog)."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.laps: List[tuple] = []

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.laps.append((name, dt))
        self.t0 = now
        return dt
