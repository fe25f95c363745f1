"""k = 0 correlation-engine planning helpers (port of the host half of
``apm/ops/corr_engine.py``).

At k = 0 approximate matching is exact matching. ``apm`` scores it as a
±1 bit-plane correlation: each text byte's code (its rank in the sorted
pattern alphabet) is written as ``B = max(1, ceil(log2 C))`` planes of ±1
(bytes outside the alphabet: all zero), and window ``j`` matches pattern
``p`` iff ``corr[j, p] == B * m_p``. The port keeps the gate and the
table constructors so its plan and tables equal ``apm``'s; the scan itself
is the fused kernel in :mod:`apm_torch.ops.corr_fused`. The XLA conv
(``scan_corr_mxu``, 97 < m_max <= 512) is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np

# Channels beyond this dilute the contraction; larger pattern alphabets go
# to the banded engine.
ALPHABET_MAX = 16

# Conv kernel width cap of apm's XLA correlation engine.
M_MAX_CORR = 512

# "auto" crossover of apm's plan (measured on apm's TPU; the port copies it
# so both packages route alike — re-measuring it on the H100 is open work).
AUTO_MIN_WORK = 256
AUTO_MIN_MMAX = 48

# Minimum piece length for apm's conv phase 1 (k >= 1); part of the plan.
FP1_LMIN = 10


def build_alphabet(raw_patterns) -> np.ndarray:
    """Sorted distinct bytes across the pattern set, as (C,) uint8."""
    if not raw_patterns:
        return np.zeros((0,), dtype=np.uint8)
    cat = np.concatenate(
        [np.frombuffer(bytes(p), dtype=np.uint8) for p in raw_patterns]
    )
    return np.unique(cat)


def n_bitplanes(alphabet_size: int) -> int:
    """±1 channel count for a C-symbol alphabet: ``max(1, ceil(log2 C))``."""
    return max(1, (max(alphabet_size, 1) - 1).bit_length())


def corr_eligible(
    plens, alphabet_size: int, m_max: int, k: int, auto: bool = False
) -> bool:
    """Gate for the correlation engine (``apm``'s ``corr_eligible``).

    With ``auto=True`` the crossover applies on top of the hard
    requirements: corr takes the scan only when the pattern set is heavy
    (``sum >= AUTO_MIN_WORK``) or long (``m_max >= AUTO_MIN_MMAX``).
    """
    ok = (
        k == 0
        and 0 < alphabet_size <= ALPHABET_MAX
        and 0 < m_max <= M_MAX_CORR
        and any(m > 0 for m in plens)
    )
    if not ok or not auto:
        return ok
    return sum(plens) >= AUTO_MIN_WORK or m_max >= AUTO_MIN_MMAX


def fp1_conv_eligible(plens, k: int, alphabet_size: int) -> bool:
    """True when EVERY filtration pattern can run apm's conv phase 1
    (exact-tier pieces of at least ``FP1_LMIN`` bytes). The port computes
    it only so that its plan equals ``apm``'s."""
    from .filter_kernel import pieces_of_j, tier_of

    if k < 1 or not (0 < alphabet_size <= ALPHABET_MAX):
        return False
    ms = [m for m in plens if m > 0]
    if not ms:
        return False
    for m in ms:
        tier = tier_of(m, k)
        if tier is None or tier[1] != 0:
            return False
        j = tier[0]
        if min(length for _, length in pieces_of_j(m, j)) < FP1_LMIN:
            return False
        if max(length for _, length in pieces_of_j(m, j)) > M_MAX_CORR:
            return False
    return sum(ms) >= AUTO_MIN_WORK or max(ms) >= AUTO_MIN_MMAX
