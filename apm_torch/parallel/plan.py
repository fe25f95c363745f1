"""Execution planner: the TPU analog of the reference's runtime cost model.

Copy of ``apm/parallel/plan.py`` (pure Python), so the port imports without
JAX and plans the same block width and the same strategy
(``Scanner._resolve_strategy``, :mod:`apm_torch.parallel.strategies`).

The reference picks between its two MPI strategies with a ratio heuristic
(``getRatio`` at ``src/main.c:21-28``, applied at ``main.c:88-139``; the
derivation lives in ``Workflow.md:100-271``): it measures how well the
pattern count divides over active ranks vs over OMP threads and runs the
strategy that wastes less. On TPU most of that decision dissolves — one
GSPMD program shards the window axis *and* vectorizes the pattern axis at
the same time — but two planning decisions remain real:

* which mesh axis to shard (windows vs patterns) when devices > 1;
* the kernel block width ``w`` (windows per grid step), which trades VMEM
  footprint against grid overhead.

Both are derived here from ``(n, m_max, P, k, n_dev)`` — statically, before
compilation, like the reference's selector (every rank computes the same
deterministic answer, ``main.c:110-114``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.common import round_up


def get_ratio(x: float) -> float:
    """Literal port of the reference's waste metric (``src/main.c:21-28``).

    Doubles ``x`` until it reaches 1, then reports the overshoot. 0 means the
    division is perfectly balanced; larger means more idle capacity. Kept for
    parity/testing and for the strategy choice below.
    """
    if x <= 0:
        return float("inf")
    while x < 1:
        x *= 2
    return x - 1


# Upper window-count bound for pattern sharding: 4x the largest corpus in
# the measured crossover grid (4 MB; bench/crossover_cpu8.jsonl). Beyond
# it the un-measured corpus-replication transfer cost dominates on real
# multi-chip hardware, so the window axis is sharded instead.
# CPU-mesh-calibrated: see the health warning in choose_strategy.
PATTERNS_NW_MAX = 16 << 20


def choose_strategy(
    n: int,
    m_max: int,
    p: int,
    k: int,
    n_dev: int,
    *,
    flat_p_engine: bool = False,
) -> str:
    """Pick the mesh axis to shard. The reference derived its crossover
    from the ``getRatio`` waste metric (``main.c:88-139``,
    ``Workflow.md:100-271``); this rule is set from a measured grid
    instead (``bench/crossover.py`` → ``bench/crossover_cpu8.jsonl``,
    8-device mesh, measured 2026-08-20, corpus 64 KB-4 MB x P 8-128,
    k = 1, 3 reps):

    * ``p == n_dev`` (one pattern per device — zero padding on either
      axis, no halo staging, no psum): patterns-over-devices won at
      EVERY corpus size, 1.22-3.88x (db_t/pat_t; the 3.88 is 64 KB
      where strategy-B per-shard fixed costs dominate).
    * ``p >= 4*n_dev``: statistical tie (0.79-1.14 across the grid) —
      both axes split cleanly; database wins the tie because its halo
      (``n_dev * m_max`` bytes total) is cheaper than replicating the
      corpus to every device, and its shards parallelize the staging.
    * ``p < n_dev``: patterns would idle ``n_dev - p`` devices entirely
      — database sharding uses all of them.

    The rule applies only inside (4x of) the measured corpus range:
    patterns-over-devices replicates the corpus to every device, a cost
    that grows with ``n`` and that the shared-memory CPU mesh
    structurally cannot observe (replication there is free; on real
    multi-chip hardware it is ``n_dev``x the h2d bytes). The measured
    win narrows with size (3.88x at 64 KB -> 1.22x at 4 MB), so beyond
    ``PATTERNS_NW_MAX`` (16 MB of windows = 4x the largest measured
    point) database sharding — which transfers each corpus byte once —
    is the safe default.

    Round 1 asserted ``nw < 4*n_dev*1024 and p >= 8*n_dev`` (tiny
    corpus, many patterns) from the then-slow dynamic-length path; the
    measured grid shows that region is a tie, so the rule collapsed to
    the one measured win (VERDICT r3 ask #4).

    **Health warning — CPU-mesh calibration.** The ``p == n_dev`` win
    and ``PATTERNS_NW_MAX`` were measured on an 8-device *virtual CPU
    mesh*, where "replicating the corpus to every device" is a no-op
    (shared host memory). On real multi-chip hardware that replication
    is ``n_dev``x the h2d bytes plus ``n_dev``x the per-device encode —
    a cost this calibration structurally cannot see, so the crossover
    may flip well below ``PATTERNS_NW_MAX``. Treat the rule as a
    CPU-mesh artifact: re-measure the ``bench/crossover.py`` grid on
    silicon before trusting it for multi-chip deployment (DESIGN §3).

    ``flat_p_engine=True`` pins database: the k = 0 correlation engine's
    throughput is flat in P (DESIGN §8 — marginal patterns ride idle MXU
    columns), so replicating the corpus encode per device is pure loss.
    """
    if n_dev <= 1:
        return "single"
    nw = max(n - k, 0)
    if nw < n_dev:  # degenerate: fewer windows than devices
        return "single"
    if not flat_p_engine and p == n_dev and nw <= PATTERNS_NW_MAX:
        return "patterns_over_devices"
    return "database_over_devices"


def choose_block_windows(nw: int, m_max: int, p: int, k: int) -> int:
    """Kernel block width: windows per Pallas grid step.

    Larger blocks amortize grid overhead; the VMEM footprint per block is
    roughly ``p * (2k + 1) * w * 4`` bytes of live DP band (one
    ``(FOLD, w/FOLD)`` int32 tile per pattern per diagonal) plus temporaries,
    so cap ``w`` to keep the working set well inside the 16 MB of VMEM.
    ``p`` should be the number of *distinct* patterns actually scanned.
    """
    budget = 6 << 20  # DP-band budget; leaves room for temps + text tiles
    band_rows = 2 * k + 2
    p_eff = max(p, 1)
    w_cap = budget // (band_rows * p_eff * 4)
    w = min(65536, max(1024, w_cap))
    w = round_up(min(w, max(nw, 1)), 1024)
    return max(1024, w)


@dataclass(frozen=True)
class Plan:
    strategy: str
    block_windows: int
    n_dev: int

    @staticmethod
    def make(n: int, m_max: int, p: int, k: int, n_dev: int) -> "Plan":
        strategy = choose_strategy(n, m_max, p, k, n_dev)
        w = choose_block_windows(max(n - k, 0), m_max, p, k)
        return Plan(strategy=strategy, block_windows=w, n_dev=n_dev)
