"""Counted work and the card's peaks, frozen for the benchmark.

A copy of the Myers count of ``apm_torch/utils/roofline.py`` (as the port
had it when the benchmark was defined) and of its peaks, so that a change
to the program cannot change the yardstick. ``benchmark/tests`` hold the
two equal at the cells' pattern lengths and k.

The peaks are the H100 SXM part's at its 700 W limit: the integer issue
rate assumes a 1.98 GHz SM clock, so every run prints the card's clocks
and power limit beside its numbers.
"""

from __future__ import annotations

PEAK_HBM = 3.35e12  # bytes/s
PEAK_INT_ISSUE = 132 * 128 * 1.98e9  # instructions/s

# Hyyro's bit-vector update, a logic term of up to three inputs one LOP3:
# 17 instructions and the match word's load a static step, 3 more where
# the band moves; two windows share one update where the band fits a
# 16-bit field (2k + 1 <= 15): 20 (23 moving) a pair.
MYERS_STATIC_STEP_INSTR = 18
MYERS_MOVING_STEP_INSTR = 21
MYERS_PAIR_STATIC_STEP_INSTR = 20
MYERS_PAIR_MOVING_STEP_INSTR = 23


def myers_instr(owned: int, plens, k: int) -> int:
    """Least instructions of the Myers band over ``owned`` windows: min(k, m)
    static steps and m - k moving steps per pattern, a window pair per
    update where 2k + 1 <= 15, else one window."""
    if 2 * k + 1 <= 15:
        pair = sum(min(k, m) * MYERS_PAIR_STATIC_STEP_INSTR
                   + max(m - k, 0) * MYERS_PAIR_MOVING_STEP_INSTR for m in plens if m)
        return owned * pair // 2
    return owned * sum(min(k, m) * MYERS_STATIC_STEP_INSTR
                       + max(m - k, 0) * MYERS_MOVING_STEP_INSTR for m in plens if m)


def least_seconds(instr: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the instructions over
    the issue rate and the bytes, read once, over the memory bandwidth."""
    return max(instr / PEAK_INT_ISSUE, nbytes / PEAK_HBM)
