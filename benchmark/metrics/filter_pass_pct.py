"""100 x the program's counter ``#hot windows`` over ``#windows``, summed
over the window's calls that ran the filter: the share of windows in the
rows phase 1 marks hot, which the density decision weighs against 5 %
(layer: kernels)."""


def read(run):
    spans = [c.spans for c in run.calls if c.spans and "#hot windows" in c.spans]
    windows = sum(s.get("#windows", 0) for s in spans)
    if not windows:
        return None
    return 100.0 * sum(s["#hot windows"] for s in spans) / windows
