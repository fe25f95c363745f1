"""100 x (1 - the device's busy time over the traced window's length):
busy is the union of the card's kernel, copy and memset intervals in the
``torch.profiler`` trace (layer: device)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0 or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
