"""The least time the card needs for the work the program hands its density
rescan, over the rescan's time (the device span ``rescan dp``), in %.

The work is counted from the program's counters ``#rescan windows`` (W,
window x pattern pairs) and ``#rescan cells`` (C, those pairs' pattern
bytes). Every filtration pattern is longer than k, so the frozen Myers
count (``roofline.myers_instr``) of that work is exactly k S W + M (C - k
W): S and M the static and moving step's instructions, the pair's halved
where the band fits a 16-bit field (2k + 1 <= 15). The least time is the
larger of those instructions over the integer issue rate and the call's
bytes over the memory bandwidth. A rescan that takes fewer windows or
patterns lowers the bound with the work.
"""

from benchmark import roofline


def myers_instr(windows: int, cells: int, k: int) -> int:
    """``roofline.myers_instr`` of W window x pattern pairs of C pattern
    bytes, every pattern longer than ``k``."""
    if 2 * k + 1 <= 15:
        static, moving = roofline.MYERS_PAIR_STATIC_STEP_INSTR, roofline.MYERS_PAIR_MOVING_STEP_INSTR
        return (k * static * windows + moving * (cells - k * windows)) // 2
    static, moving = roofline.MYERS_STATIC_STEP_INSTR, roofline.MYERS_MOVING_STEP_INSTR
    return k * static * windows + moving * (cells - k * windows)


def read(run):
    least = ms = 0.0
    for c in run.calls:
        s = c.spans or {}
        if "#rescan windows" not in s or not s.get("rescan dp"):
            continue
        instr = myers_instr(s["#rescan windows"], s["#rescan cells"], run.k)
        least += roofline.least_seconds(instr, c.nbytes)
        ms += s["rescan dp"]
    return 100.0 * least / (ms / 1e3) if ms else None
