"""The least time the card needs for the work the program hands its
overflow verify, over that verify's time (the device span
``count_hot_batch``), in %.

The work is counted from the program's counters ``#verify windows`` (W,
window x pattern pairs: a chunk's full hot rows x their windows x the
filtration patterns) and ``#verify cells`` (C, those pairs' pattern
bytes), with ``rescan_roofline``'s frozen Myers count of such work. That
count is the least of any implementation: where the program verifies with
kernel A's classic band (a set whose Myers table passes its budget), the
share reads A's time against what the bit-parallel band could do. The
least time is those instructions over the integer issue rate; the hot
rows' bytes are left out (a row of ``wf + halo`` bytes carries ``wf`` x P
x m cells), so the bound stays a floor. Calls without the counters, such
as a verify on the "split-rescan" route, are left out.
"""

from benchmark import roofline
from benchmark.metrics.rescan_roofline import myers_instr


def read(run):
    least = ms = 0.0
    for c in run.calls:
        s = c.spans or {}
        if "#verify windows" not in s or not s.get("count_hot_batch"):
            continue
        instr = myers_instr(s["#verify windows"], s["#verify cells"], run.k)
        least += roofline.least_seconds(instr, 0)
        ms += s["count_hot_batch"]
    return 100.0 * least / (ms / 1e3) if ms else None
