"""The program's host span ``launch`` over its counter ``#chunks``, both
summed over the window's calls: the host's enqueue of one chunk, any wait
in it included, which a call of many chunks pays once a chunk (layer:
chunk loop). None where no call counted its chunks."""


def read(run):
    spans = [c.spans for c in run.calls if c.spans and c.spans.get("#chunks")]
    if not spans:
        return None
    return sum(s.get("launch", 0.0) for s in spans) / sum(s["#chunks"] for s in spans)
