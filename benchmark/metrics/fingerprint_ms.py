"""Per call: the program's host span ``fingerprint``, the corpus's key in
the device cache (layer: device corpus cache)."""


def read(run):
    return run.span_ms(("fingerprint",))
