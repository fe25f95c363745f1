"""Pigeonhole-filtration planning helpers (port of the host half of
``apm/ops/filter_kernel.py``).

``make_plan`` partitions patterns by filtration tier exactly as ``apm``
does, so the two packages agree on the plan. The filtration kernel itself
(``apm/ops/filter_kernel.py::scan_filter_pallas``) is not ported yet
(``ROADMAP.md``, Queue 2); until it is, the Scanner sends
``plan.plens_filter`` to the banded-DP kernel, which counts exactly.

Tiers (Navarro's pigeonhole taxonomy): split a pattern of length ``m`` into
``j`` pieces; a window within edit distance ``k`` has some piece matching
with at most ``floor(k / j)`` errors. The exact tier uses ``j = k + 1``
pieces with 0 errors, the banded tier ``j = k//2 + 1`` pieces with 1 error.
"""

from __future__ import annotations

FOLD = 8  # apm's fold-8 int32 layout; make_plan rounds block widths to it
K_MAX = 16  # filtration eligibility cap (both tiers)

# Minimum piece length per tier (selectivity bound; see apm's module doc).
EXACT_LMIN_HIGH = 14  # exact tier, k >= 5
BANDED_LMIN = {5: 14, 6: 14, 7: 14, 8: 14}  # else 16 for k in [9, 16]


def pieces_of_j(m: int, j: int):
    """Static piece table: [(offset, length)] — j contiguous pieces."""
    l = m // j
    return [(i * l, l if i < j - 1 else m - (j - 1) * l) for i in range(j)]


def banded_j(k: int) -> int:
    """Piece count of the banded tier: the fewest pieces with k//j == 1."""
    return k // 2 + 1


def tier_of(m: int, k: int):
    """Filtration plan for one pattern: ``(j, kp)`` or None (banded DP).

    Exact pieces are preferred (cheaper and more selective); the banded
    tier extends coverage to mid-length patterns at k in [5, 16].
    """
    if m < 1:
        return None
    if k == 0:
        return (1, 0)
    if k <= 4:
        return (k + 1, 0) if m // (k + 1) >= max(k, 8) else None
    if k <= K_MAX:
        if m // (k + 1) >= EXACT_LMIN_HIGH:
            return (k + 1, 0)
        j = banded_j(k)
        if m // j >= BANDED_LMIN.get(k, 16):
            return (j, 1)
    return None


def filter_eligible(m: int, k: int) -> bool:
    """True when some filtration tier applies to an (m, k) pattern."""
    return tier_of(m, k) is not None


def partition_plens(plens: tuple, k: int, engine: str):
    """Split a static length tuple into (fmask, filtration, banded-DP)."""
    use = engine in ("auto", "filter")
    fmask = tuple(use and m > 0 and filter_eligible(m, k) for m in plens)
    plens_filter = tuple(m if f else 0 for m, f in zip(plens, fmask))
    plens_dp = tuple(0 if f else m for m, f in zip(plens, fmask))
    return fmask, plens_filter, plens_dp
