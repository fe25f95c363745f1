"""Per call: the program's device span ``copy``, the rows' copy to the
card (layer: host staging)."""


def read(run):
    return run.span_ms(("copy",))
