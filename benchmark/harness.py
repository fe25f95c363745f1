"""Run one cell of ``BENCHMARK.json`` once: set-up, the measured window,
the check against the plain reference, and the result line.

A cell names a configuration and a traffic mix; both, and every metric,
are files found by name (``spec.py``). The window is a closed loop of
calls from one caller: each call is sent when the previous one returns.
With ``trace`` on, the program's spans are on and ``torch.profiler`` runs
over the window; the per-layer metrics are read from both.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import devtrace, spec
from .workload import WARM, Request, Workload

FORBIDDEN = ("jax", "jaxlib", "flax", "apm")
EXACT = 0  # every count compared must equal the reference's: no mismatch allowed


@dataclass
class Call:
    index: int
    key: int
    seconds: float  # host clock, from the call's start to its counts on the host
    nbytes: int
    init_s: Optional[float]  # Scanner(...), in the calls that built one
    spans: Optional[Dict[str, float]]  # the program's spans, traced runs only
    patterns: List[bytes]
    answer: np.ndarray  # (corpora, patterns) counts


@dataclass
class Run:
    """What a metric reader reads."""

    root: str
    cell: spec.Cell
    seed: int
    traced: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: List[Call] = field(default_factory=list)
    window_peak_bytes: int = 0
    trace: Optional[dict] = None

    @property
    def k(self) -> int:
        return int(self.cell.traffic["k"])

    def metric(self, name: str) -> Optional[float]:
        """Another metric's value, by its reader."""
        return spec.reader(self.root, name)(self)

    def span_ms(self, names) -> Optional[float]:
        """Per call: the window's total of the named spans over its calls;
        None where no call recorded any of them."""
        spans = [c.spans for c in self.calls if c.spans is not None]
        if not spans or not any(n in s for s in spans for n in names):
            return None
        return sum(s.get(n, 0.0) for s in spans for n in names) / len(self.calls)


def device_lines(device) -> List[str]:
    """The card's name, clocks and power, for the record."""
    out = [f"device {torch.cuda.get_device_name(device)}"]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
        out.append(f"nvidia-smi {smi.stdout.strip() or smi.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        out.append(f"nvidia-smi not read: {e}")
    return out


class Caller:
    """Makes one call of the traffic's kind on a request. A ``Scanner`` is
    built inside the call whenever the request's patterns differ from the
    current one's, so a stream of new pattern sets builds one a call and a
    fixed set or panel one for the run."""

    def __init__(self, work: Workload, device, traced: bool):
        from apm_torch import ApmConfig, Scanner

        self.Scanner = Scanner
        self.cfg = ApmConfig(device=str(device))
        self.kind = work.traffic["call"]
        if self.kind not in ("count", "count_batch"):
            raise ValueError(f"unknown call {self.kind!r}")
        self.k, self.traced = work.k, traced
        self.sc, self.patterns = None, None

    def __call__(self, req: Request):
        mark = torch.profiler.record_function if self.traced else lambda _: nullcontext()
        init_s = None
        if req.patterns != self.patterns:
            self.sc = None  # the last set's Scanner, and its device cache, go first
            t0 = time.perf_counter()
            with mark("scanner init"):
                self.sc = self.Scanner(req.patterns, self.k, self.cfg)
            init_s = time.perf_counter() - t0
            self.sc.meter.trace = self.traced
            self.patterns = req.patterns
        with mark(self.kind):
            if self.kind == "count":
                answer = self.sc.count(req.corpora[0])[None, :]
            else:
                answer = self.sc.count_batch(req.corpora)
        spans = dict(self.sc.meter.last_spans) if self.traced else None
        return np.asarray(answer, dtype=np.int64), init_s, spans

    def release(self) -> None:
        self.sc, self.patterns = None, None


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: Optional[str] = None, log=print,
             min_calls: int = 1) -> dict:
    """One run of cell ``workload``; returns the result line's object.
    ``device`` (default ``cuda:0``) is for the CPU tests; a run on the card
    leaves it unset. The window closes ``seconds`` after it opens, once
    ``min_calls`` calls have returned."""
    cell = spec.find_cell(root, workload)
    dev = torch.device(device or "cuda:0")
    on_card = dev.type == "cuda"
    if on_card:
        for line in device_lines(dev):
            log(line)
    run = Run(root=str(root), cell=cell, seed=int(seed), traced=bool(trace))
    work = Workload(cell.config, cell.traffic, seed, dev)
    caller = Caller(work, dev, run.traced)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(int(cell.traffic.get("warmup_calls", 2))):
        caller(work.request(WARM + i))
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    run.setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    prof = devtrace.profiler() if run.traced else None
    with devtrace.marked_host_spans() if prof else nullcontext():
        if prof:
            prof.start()
        with torch.profiler.record_function("window") if prof else nullcontext():
            w0 = time.perf_counter()
            end = w0 + float(seconds)
            i = 0
            while True:
                req = work.request(i)
                t0 = time.perf_counter()
                answer, init_s, spans = caller(req)
                t1 = time.perf_counter()
                run.calls.append(Call(i, req.key, t1 - t0, req.nbytes, init_s, spans,
                                      req.patterns, answer))
                i += 1
                if t1 >= end and i >= min_calls:
                    break
            sync()
            run.window_s = time.perf_counter() - w0
        if prof:
            prof.stop()
    if on_card:
        run.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
    memory_peak = max(setup_peak, run.window_peak_bytes)
    if prof:
        run.trace = devtrace.reduce(prof, [caller.kind])
        del prof

    # the program's state goes before the reference runs
    caller.release()
    del caller
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared, failed = check(run, work, dev, log)

    metrics = {}
    wanted = cell.per_layer if run.traced else cell.end_to_end
    for m in wanted:
        value = run.metric(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    found = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if found:
        raise RuntimeError(f"modules of {found} were loaded in the run's process")

    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": int(cell.entry["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    out = {
        "correct": compared["mismatched_counts"]["value"] <= EXACT and failed == 0,
        "attempted": len(run.calls),
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["compared"] = compared
    return out


def check(run: Run, work: Workload, dev, log) -> tuple:
    """Compares the answers of a sample of the window's requests, drawn
    from the seed, with the plain reference: every call that asked a
    sampled question. Returns ``(compared, failed calls)``."""
    keys = sorted({c.key for c in run.calls})
    n_keys = min(len(keys), int(run.cell.traffic.get("check_calls", 4)))
    rng = np.random.default_rng(np.random.SeedSequence([run.seed, 9]))
    sample = set(np.asarray(keys)[rng.choice(len(keys), size=n_keys, replace=False)].tolist())
    ref = spec.module(run.root, run.cell.config["reference"])
    mismatched = failed = checked = 0
    for key in sorted(sample):
        calls = [c for c in run.calls if c.key == key]
        req = work.request(calls[0].index)
        t0 = time.perf_counter()
        want = ref.count_many(req.corpora, req.patterns, work.k, dev)
        log(f"reference: request {calls[0].index} ({len(calls)} calls) in "
            f"{time.perf_counter() - t0:.3f} s")
        for c in calls:
            bad = int((c.answer != want).sum())
            mismatched += bad
            failed += bad > 0
            checked += 1
    log(f"compared {checked} calls of {len(run.calls)} ({n_keys} distinct requests)",
        file=sys.stderr)
    return {"mismatched_counts": {"value": mismatched, "limit": EXACT}}, failed

