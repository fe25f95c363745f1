"""The 95th percentile of every call's host-clock time in the window, in
ms: a call runs from its start until its counts are on the host; a
per-call Scanner is built inside it."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([c.seconds for c in run.calls], 95)) * 1e3
