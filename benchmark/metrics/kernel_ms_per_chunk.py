"""``kernel_ms`` (the device spans of the kernel routes, per call) over
the program's counter ``#chunks`` per call: a chunk's kernel time, to set
beside ``kernel_ms`` of a one-chunk cell (layer: kernels). None where no
call counted its chunks."""


def read(run):
    chunks = sum(c.spans.get("#chunks", 0) for c in run.calls if c.spans)
    kernel_ms = run.metric("kernel_ms")
    if not chunks or kernel_ms is None:
        return None
    return kernel_ms * len(run.calls) / chunks
