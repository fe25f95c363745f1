"""Randomized conformance fuzz of the scan paths (port of
``bench/fuzz_tpu.py``).

Each trial draws ``(k, pattern lengths, alphabet)`` from :data:`POOL`, a
random corpus (DNA text, or raw bytes with NUL and 0xFF) and random
patterns over the corpus's alphabet; every other trial also plants real
copies of each pattern with up to k substitutions. The checks, against
the NumPy oracle (:mod:`apm_torch.utils.oracle`):

* every trial: ``Scanner.count`` against ``count_matches`` (on the
  ``find`` trials, the number of windows ``banded_distances`` puts within
  k, the same count from the same pass);
* every :data:`FIND_EVERY`-th trial: ``Scanner.find`` against those
  windows;
* every :data:`BATCH_EVERY`-th trial: ``Scanner.count_batch`` of the
  corpus's two halves against their counts;
* every :data:`SHARD_EVERY`-th trial: ``count_distributed(...,
  "database_over_devices", [device] * 2)`` (two shards on one device)
  against the counts.

Trials are drawn from the seed in ``apm``'s order, so a seed gives the
same corpora and patterns as ``bench/fuzz_tpu.py``. The oracle of every
trial is computed on ``workers`` host threads (NumPy releases the GIL in
its array loops) while the device checks run; it is the same oracle, only
earlier. :func:`run_fuzz` stops at the first mismatch and returns it; no
trial and no check is skipped.

    python -m apm_torch.utils.fuzz --trials 36 --seed 0 [--device cpu]
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .oracle import banded_distances, count_matches

# (k, pattern lengths, alphabet): short DP-only patterns, the filtration's
# exact tier, the banded tier (k in [5, 16], mid lengths), the Myers
# regime and raw bytes.
POOL = [
    (0, (7, 50), "dna"),
    (0, (50, 50, 32), "dna"),
    (1, (24, 50), "dna"),
    (1, (20, 40), "bin"),
    (2, (9, 33), "dna"),
    (4, (50, 80), "dna"),
    (6, (24, 64), "dna"),
    (12, (112,), "dna"),
    (16, (40, 140), "dna"),
]

# How often a trial also runs find, count_batch and the two-shard database
# strategy (``bench/fuzz_tpu.py``'s cadence for the first two).
FIND_EVERY, BATCH_EVERY, SHARD_EVERY = 4, 5, 3

_DNA = np.frombuffer(b"ACGT\n", dtype=np.uint8)


@dataclass
class Trial:
    k: int
    plens: tuple
    alphabet: str
    corpus: np.ndarray
    patterns: List[bytes]


@dataclass
class FuzzResult:
    trials: int  # trials asked for
    passed: int  # trials whose every check agreed
    seconds: float
    mismatch: Optional[str] = None  # the first disagreement, if any
    checks: dict = field(default_factory=dict)  # check name -> times run


def draw_trials(trials: int, seed: int, max_bytes: int) -> List[Trial]:
    """The trials of a run, drawn from ``seed`` as ``bench/fuzz_tpu.py``
    draws them (corpora of ``[min(64 KB, max_bytes), max_bytes]`` bytes)."""
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(trials):
        k, plens, kind = POOL[trial % len(POOL)]
        n = int(rng.integers(min(64 << 10, max_bytes), max_bytes + 1))
        if kind == "dna":
            corpus = _DNA[rng.integers(0, 5, size=n)]
        else:  # raw bytes, NUL and 0xFF included
            corpus = rng.integers(0, 256, size=n, dtype=np.uint16).astype(np.uint8)
        pats = []
        for m in plens:
            if kind == "dna":
                pats.append(_DNA[rng.integers(0, 4, size=m)])
            else:
                pats.append(rng.integers(0, 256, size=m, dtype=np.uint16).astype(np.uint8))
        if trial % 2 == 0:  # plant copies with up to k substitutions
            for p in pats:
                for _ in range(int(rng.integers(1, 6))):
                    occ = p.copy()
                    for _ in range(int(rng.integers(0, k + 1))):
                        occ[rng.integers(0, len(occ))] = (
                            _DNA[rng.integers(0, 4)] if kind == "dna" else rng.integers(0, 256)
                        )
                    j = int(rng.integers(0, n - len(occ)))
                    corpus[j : j + len(occ)] = occ
        corpus.setflags(write=False)
        out.append(Trial(k, plens, kind, corpus, [bytes(p.tobytes()) for p in pats]))
    return out


def _positions(corpus, pat, k) -> np.ndarray:
    return np.nonzero(banded_distances(corpus, pat, k) <= k)[0].astype(np.int64)


def run_fuzz(
    trials: int = 36,
    seed: int = 0,
    device: str = "cuda",
    max_bytes: int = 1 << 20,
    *,
    workers: int = 1,
    log=None,
) -> FuzzResult:
    """Run ``trials`` trials (module doc) on ``device``. Returns a
    :class:`FuzzResult` whose ``mismatch`` names the first disagreement (the
    run stops there), or None when every check of every trial agreed; an
    error in the scan raises. ``log(line)`` gets one line per trial."""
    from ..models.scanner import Scanner
    from ..parallel.strategies import count_distributed
    from .config import ApmConfig

    t0 = time.perf_counter()
    todo = draw_trials(trials, seed, max_bytes)
    checks = {"count": 0, "find": 0, "count_batch": 0, "database_over_devices": 0}
    with ThreadPoolExecutor(max(1, workers)) as pool:
        oracle: List[dict] = []
        for i, t in enumerate(todo):
            jobs: dict = {}
            if i % FIND_EVERY == 1:
                # one banded_distances pass a pattern gives positions and counts
                jobs["find"] = [pool.submit(_positions, t.corpus, p, t.k) for p in t.patterns]
            else:
                jobs["count"] = pool.submit(count_matches, t.corpus, t.patterns, t.k)
            if i % BATCH_EVERY == 2:
                half = len(t.corpus) // 2
                jobs["batch"] = [pool.submit(count_matches, part, t.patterns, t.k)
                                 for part in (t.corpus[:half], t.corpus[half:])]
            oracle.append(jobs)

        def get(f):
            return [g.result() for g in f] if isinstance(f, list) else f.result()

        passed, mismatch = 0, None
        try:
            for i, (t, jobs) in enumerate(zip(todo, oracle)):
                sc = Scanner(t.patterns, t.k, ApmConfig(block_windows=8192, device=device))
                want = (get(jobs["count"]) if "count" in jobs
                        else [len(pos) for pos in get(jobs["find"])])
                got = sc.count(t.corpus).tolist()
                checks["count"] += 1
                if got != want:
                    mismatch = f"count: got {got}, oracle {want}"
                if mismatch is None and "find" in jobs:
                    checks["find"] += 1
                    for pi, (pos, wpos) in enumerate(zip(sc.find(t.corpus), get(jobs["find"]))):
                        if not np.array_equal(np.asarray(pos, dtype=np.int64), wpos):
                            mismatch = (f"find pattern {pi}: {len(pos)} positions, "
                                        f"oracle {len(wpos)}")
                            break
                if mismatch is None and "batch" in jobs:
                    checks["count_batch"] += 1
                    half = len(t.corpus) // 2
                    bc = sc.count_batch([t.corpus[:half], t.corpus[half:]]).tolist()
                    if bc != get(jobs["batch"]):
                        mismatch = f"count_batch: got {bc}, oracle {get(jobs['batch'])}"
                if mismatch is None and i % SHARD_EVERY == 0:
                    checks["database_over_devices"] += 1
                    dev = sc.device
                    sh = count_distributed(sc, t.corpus, "database_over_devices", [dev, dev])
                    sh = sh[: sc.scan_patterns.num_patterns][sc._inverse].tolist()
                    if sh != want:
                        mismatch = f"database_over_devices x2: got {sh}, oracle {want}"
                if log is not None:
                    log(f"[{i + 1:3}/{trials}] k={t.k} plens={t.plens} alpha={t.alphabet} "
                        f"n={len(t.corpus)} -> {mismatch or 'ok'}")
                if mismatch is not None:
                    mismatch = (f"trial {i + 1} (k={t.k}, plens={t.plens}, "
                                f"alpha={t.alphabet}, n={len(t.corpus)}): {mismatch}")
                    break
                passed += 1
        finally:
            for jobs in oracle:  # a stopped run leaves no oracle work behind
                for f in jobs.values():
                    for g in f if isinstance(f, list) else [f]:
                        g.cancel()
    return FuzzResult(trials, passed, time.perf_counter() - t0, mismatch, checks)


def main(argv=None) -> int:
    import argparse
    import os
    import sys

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=36)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-bytes", type=int, default=1 << 20)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    res = run_fuzz(args.trials, args.seed, args.device, args.max_bytes,
                   workers=args.workers, log=lambda line: print(line, file=sys.stderr, flush=True))
    if res.mismatch is not None:
        print(f"FUZZ FAILED at {res.mismatch}")
        return 1
    print(f"{res.passed} fuzz trials passed on {args.device} in {res.seconds:.1f} s, "
          f"checks {res.checks}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
