"""Per call: the program's host span ``fold``, the corpus folded into
page-locked rows (layer: host staging)."""


def read(run):
    return run.span_ms(("fold",))
