"""The least time the card needs for the window's Myers work over the
kernels' time (``kernel_ms``), in %.

The least time is the larger of two bounds: the instructions of the Myers
band over every window of each call's corpus, for its distinct patterns at
its k (the benchmark's frozen ``myers_instr``), over the integer issue
rate, and the corpus bytes read once over the memory bandwidth. It counts
the work these inputs need only where no filter can drop a window (k = 12
against 32- and 50-byte patterns); it stands in no other cell.
"""

from benchmark import roofline


def read(run):
    kernel_ms = run.metric("kernel_ms")
    if not kernel_ms:
        return None
    least = 0.0
    for c in run.calls:
        plens = [len(p) for p in set(c.patterns)]  # each distinct pattern once
        owned = max(c.nbytes - run.k, 0)
        least += roofline.least_seconds(roofline.myers_instr(owned, plens, run.k), c.nbytes)
    return 100.0 * least / (kernel_ms * len(run.calls) / 1e3)
