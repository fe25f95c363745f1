"""Corpus bytes of every call completed in the window over the window's
seconds (host clock), in MB/s."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c.nbytes for c in run.calls) / run.window_s / 1e6
