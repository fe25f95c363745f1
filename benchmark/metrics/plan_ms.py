"""Per call: the program's host span ``plan``, the strategy, the scan's
plan and the set-up its chunks share (layer: plan)."""


def read(run):
    return run.span_ms(("plan",))
