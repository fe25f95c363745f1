"""The least time the card needs for the work the program hands kernel D,
over phase 1's time (the device span ``phase 1``), in %.

The work is the program's counter ``#piece windows``: each owned window
times the pieces of the filtration patterns that kernel D takes, ``k + 1``
a pattern in the exact tier and ``k // 2 + 1`` in the banded tier. Each
costs ``COMPARE_INSTR`` instructions, a piece's head compared at every
position: the floor of the program's ``filter_shiftor_model``
(``apm_torch/utils/roofline.py``), frozen here. The least time is the
larger of those instructions over the integer issue rate and the call's
bytes over the memory bandwidth. A call that kernel D does not serve
carries no counter and is left out.
"""

from benchmark import roofline

COMPARE_INSTR = 3  # the program's COMPARE_OPS when the benchmark took it


def read(run):
    least = ms = 0.0
    for c in run.calls:
        s = c.spans or {}
        if "#piece windows" not in s or not s.get("phase 1"):
            continue
        least += roofline.least_seconds(COMPARE_INSTR * s["#piece windows"], c.nbytes)
        ms += s["phase 1"]
    return 100.0 * least / (ms / 1e3) if ms else None
