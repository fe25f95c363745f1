"""Per call: the program's root span ``call`` less its ``wait`` spans, the
blocking reads of device results: the host's own time in a call (layer:
entry)."""


def read(run):
    call = run.span_ms(("call",))
    if call is None:
        return None
    return call - (run.span_ms(("wait",)) or 0.0)
