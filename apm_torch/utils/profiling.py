"""Tracing, profiling and throughput lines (port of
``apm/utils/profiling.py``).

* :class:`Spans` — the program's one tracer: the spans and counters of one
  call, recorded at the layer boundaries where the work is dispatched.
  ``Meter.trace`` (or :func:`trace`) turns them on; each call then leaves
  its totals in ``Meter.last_spans`` and its spans in ``Meter.last_records``;
* :func:`trace` — a ``torch.profiler`` bracket around scans that turns the
  program's spans on and writes a Chrome trace (``apm``'s is a
  ``jax.profiler`` one), viewable in Perfetto or ``chrome://tracing``:
  each span is a range on the profiler's clock, beside the kernels;
  :func:`profiler` is the profiler it opens;
* :class:`ScanStats` — one scan's throughput line (``config.verbose``);
* :func:`info` — the ``APM_INFO`` analog, gated by config/env instead of a
  compile-time ``-D`` flag.
"""

from __future__ import annotations

import contextvars
import os
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional


def info(msg: str, *, enabled: bool = True) -> None:
    """APM_INFO analog: runtime-gated progress line on stderr."""
    if enabled or os.environ.get("APM_INFO"):
        print(f"[apm] {msg}", file=sys.stderr, flush=True)


def profiler(cpu: bool = True, record_shapes: bool = False):
    """A ``torch.profiler.profile`` over the host's operators (``cpu``)
    and, when a card is present, its kernels, copies and memsets.
    ``record_shapes`` also keeps each operator's inputs, and so each span's
    call id (:class:`Spans`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if cpu else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=record_shapes)


# True inside a `trace` block: the program's spans are on there
_TRACING = contextvars.ContextVar("apm_torch_tracing", default=False)


def tracing() -> bool:
    """True inside a :func:`trace` block (of this thread or task)."""
    return _TRACING.get()


@contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace around scans, with the program's
    spans on.

    Usage::

        with profiling.trace("traces"):
            scanner.count(corpus)

    Inside the block every ``Scanner`` call records its spans, as under
    ``Meter.trace``: each is a range in the trace (``call``, ``plan``,
    ``launch``, ``phase 1``, ``wait``, ...), nested as the spans are, with
    the call's id as its argument. On exit, as ``apm``'s, the trace is
    written whether or not the block raised, to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format); an exception
    from the block propagates."""
    import torch

    os.makedirs(log_dir, exist_ok=True)
    prof = profiler(record_shapes=True)
    token = _TRACING.set(True)
    prof.start()
    try:
        yield log_dir
    finally:
        _TRACING.reset(token)
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end inside the trace
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


@dataclass
class ScanStats:
    """One scan's throughput line."""

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

    def line(self) -> str:
        return (
            f"{self.corpus_bytes} B x {self.patterns} pat "
            f"({self.unique_patterns} uniq) k={self.k} "
            f"[{self.strategy}/{self.backend} w={self.block_windows}] "
            f"in {self.seconds:.4f} s -> {self.mb_per_s:.1f} MB/s"
        )


class Span(NamedTuple):
    """One closed span of a call, in milliseconds: on the host clock
    (``perf_counter_ns``), or for a device span on a CUDA device on the
    device's, from the call's first device event."""

    name: str
    parent: Optional[str]  # the span open around it; None for the root
    call: int  # the call's id
    device: bool  # timed by a CUDA event pair
    start: float
    end: float


_OFF_SPAN = nullcontext()  # what a span is with tracing off: nothing to allocate


class Spans:
    """The spans and counters of one call.

    ``host(name)`` brackets host work with the host clock. ``device(name)``
    brackets work queued on the device: on a CUDA device two CUDA events on
    the current stream, so the span is the device timeline from the first
    queued piece of work to the last, launch gaps included; elsewhere the
    host clock (the work runs synchronously). Spans nest: each records the
    span open around it, and each name's brackets sum in :meth:`totals`.
    ``count(name, n)`` adds ``n`` to a counter of the call. Where a
    ``torch.profiler`` session runs, each span is also a range in it, named
    as the span, with the call's id as its argument (kept where the session
    records shapes), so the profiler's clock holds the program's spans
    beside the kernels. Off, a span or a counter costs one test.
    """

    def __init__(self, device=None, enabled: bool = False, call: int = 0):
        self.enabled = enabled
        self.call = call
        self.records: List[Span] = []
        self._cuda = enabled and device is not None and device.type == "cuda"
        self._ranges = False
        if enabled:
            import torch

            self._ranges = torch.autograd._profiler_enabled()
        self._open: List[str] = []
        self._events: List[tuple] = []  # (name, parent, start event, end event)
        self._counts: Dict[str, int] = {}

    def host(self, name: str):
        if not self.enabled:
            return _OFF_SPAN
        return self._span(name, False)

    def device(self, name: str):
        if not self.enabled:
            return _OFF_SPAN
        if not self._cuda:
            return self.host(name)
        return self._span(name, True)

    def count(self, name: str, n: int) -> None:
        if self.enabled:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    @contextmanager
    def _span(self, name: str, on_device: bool):
        import torch

        parent = self._open[-1] if self._open else None
        rng = (torch.autograd._record_function_with_args_enter(name, self.call)
               if self._ranges else None)
        self._open.append(name)
        if on_device:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        else:
            t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            if on_device:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                self._events.append((name, parent, e0, e1))
            else:
                t1 = time.perf_counter_ns()
                self.records.append(Span(name, parent, self.call, False, t0 / 1e6, t1 / 1e6))
            self._open.pop()
            if rng is not None:
                torch.autograd._record_function_with_args_exit(rng)

    def totals(self) -> Dict[str, float]:
        """Milliseconds per span name, and each counter under its name
        after ``#``; waits for the device spans' end events."""
        if self._events:
            first = self._events[0][2]
            for name, parent, e0, e1 in self._events:
                e1.synchronize()
                start = first.elapsed_time(e0)
                self.records.append(
                    Span(name, parent, self.call, True, start, start + e0.elapsed_time(e1)))
            self._events = []
        out: Dict[str, float] = {}
        for s in self.records:
            out[s.name] = out.get(s.name, 0.0) + (s.end - s.start)
        out.update((f"#{name}", n) for name, n in self._counts.items())
        return out


OFF = Spans()


@dataclass
class Meter:
    """A Scanner's trace switch and the last traced call's export.

    With ``trace`` on (or inside :func:`trace`), each call leaves its
    :class:`Spans` totals in ``last_spans`` (each span name's milliseconds,
    and each counter under a name that begins with ``#``) and its spans in
    ``last_records``; a call clears both first, so they never hold an
    earlier call's."""

    trace: bool = False
    last_spans: Dict[str, float] = field(default_factory=dict)
    last_records: List[Span] = field(default_factory=list)
