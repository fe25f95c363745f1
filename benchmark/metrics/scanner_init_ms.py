"""Per call: the harness's host clock around ``Scanner(patterns, k)``
(layer: entry), where each call builds its own Scanner."""


def read(run):
    inits = [c.init_s for c in run.calls if c.init_s is not None]
    if not inits:
        return None
    return sum(inits) / len(run.calls) * 1e3
