"""The traced window: device busy time, top device operations, idle gaps.

A ``torch.profiler`` session (host operators and the card's kernels,
copies and memsets) runs over the whole measured window. The busy time is
the union of the device's activity intervals (copied from the program's
``chip_smoke.device_busy``). Each idle stretch of the device is labelled
by what the host was doing meanwhile: one of the program's host spans
(``fold``, ``fingerprint``, ``EOF tail``, ``fetch``, ``finalize``), which
the harness marks in the trace by wrapping ``Spans.host``, a harness step
(``scanner init``), the rest of a call (``<call> other``), or the harness
between calls (``harness``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

Intervals = List[Tuple[float, float]]

# host spans of the program that label idle time, innermost first
PROGRAM_SPANS = ("fold", "fingerprint", "EOF tail", "fetch", "finalize")
HARNESS_STEPS = ("scanner init",)
NAME_CHARS = 160  # a kernel's name is cut there: templates run to thousands


def profiler():
    """Host operators and, where there is a card, its activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@contextlib.contextmanager
def marked_host_spans():
    """While open, each host span of the program (``apm_torch.utils.
    profiling.Spans.host``) is also a ``record_function`` range in the
    trace. Its own timing is unchanged."""
    from apm_torch.utils import profiling

    original = profiling.Spans.host

    @contextlib.contextmanager
    def host(self, name):
        with torch.profiler.record_function(name), original(self, name):
            yield

    profiling.Spans.host = host
    try:
        yield
    finally:
        profiling.Spans.host = original


def union(intervals: Iterable[Tuple[float, float]]) -> Intervals:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out: Intervals = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def overlap(a: Intervals, b: Intervals) -> float:
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def gaps(busy: Intervals, start: float, end: float) -> Intervals:
    """The stretches of ``[start, end]`` outside ``busy``."""
    out: Intervals = []
    t = start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def reduce(prof, call_names: Sequence[str]) -> Dict:
    """Busy seconds, the ten device operations that took most time, and the
    device's idle time by what the host was doing, over the harness's
    ``window`` range of a finished profiler session."""
    from torch.autograd import DeviceType

    marks = set(PROGRAM_SPANS) | set(HARNESS_STEPS) | set(call_names) | {"window"}
    device, host = [], {}
    for e in prof.events():
        rng = (float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name in marks or getattr(e, "is_user_annotation", False):
                continue  # a host range projected on the device's timeline
            device.append((e.name, rng))
        elif e.name in marks:
            host.setdefault(e.name, []).append(rng)
    if "window" not in host:
        raise RuntimeError("the trace holds no 'window' range")
    w0, w1 = host["window"][0]
    busy = union((max(s, w0), min(e, w1)) for _, (s, e) in device if e > w0 and s < w1)
    ops: Dict[str, float] = {}
    for name, (s, e) in device:
        ops[name] = ops.get(name, 0.0) + (e - s)
    idle = gaps(busy, w0, w1)
    by_label = {n: overlap(idle, union(host.get(n, [])))
                for n in PROGRAM_SPANS + HARNESS_STEPS}
    in_calls = overlap(idle, union(iv for c in call_names for iv in host.get(c, [])))
    inside = sum(by_label[n] for n in PROGRAM_SPANS)
    by_label[f"{'/'.join(call_names)} other"] = max(0.0, in_calls - inside)
    idle_us = sum(e - s for s, e in idle)
    by_label["harness"] = max(0.0, idle_us - in_calls - by_label["scanner init"])
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_idle = sorted(((n, v) for n, v in by_label.items() if v > 0), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": [[n[:NAME_CHARS], v / 1e6] for n, v in top_ops],
        "idle_gaps": [[n, v / 1e6] for n, v in top_idle],
    }
