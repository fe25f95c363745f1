"""100 x the program's counter ``#cache hit`` over ``#cache hit`` and
``#cache miss``, summed over the window's calls: the chunks served from
the device corpus cache (layer: device corpus cache)."""


def read(run):
    spans = [c.spans for c in run.calls if c.spans]
    hits = sum(s.get("#cache hit", 0) for s in spans)
    misses = sum(s.get("#cache miss", 0) for s in spans)
    return 100.0 * hits / (hits + misses) if hits + misses else None
