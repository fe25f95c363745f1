"""Input generators: DNA text as FASTA lines, pattern sets and contigs.

Every generator takes the run's seed and a tag, so the corpus, the pattern
sets and the contig layouts are independent streams that repeat byte for
byte under one seed. The text is made on the run's device from a
``torch.Generator`` and copied to the host once: the program receives a
host array, as a user's program would.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

NEWLINE = 10
BASES = b"ACGT"


def stream(seed: int, *tag: int) -> np.random.Generator:
    """A NumPy generator for the stream ``tag`` of ``seed``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tag]))


def torch_seed(seed: int, *tag: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, derived like :func:`stream`."""
    word = np.random.SeedSequence([int(seed), *tag]).generate_state(1, np.uint64)[0]
    return int(word) >> 1


def dna_lines(n_bytes: int, line_bases: int, seed: int, device) -> np.ndarray:
    """``n_bytes`` of uppercase ``ACGT`` in lines of ``line_bases`` bases,
    each followed by ``\\n`` (the last line may be shorter and also ends in
    ``\\n``), uniform bases from ``seed``. Returns a read-only host array."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(torch_seed(seed, 0))
    code = torch.randint(0, 4, (n_bytes,), generator=gen, device=dev, dtype=torch.uint8)
    # 0, 1, 2, 3 -> 'A' 65, 'C' 67, 'G' 71, 'T' 84 without an int64 index
    text = code * 2 + 65
    text += (code >= 2).to(torch.uint8) * 2
    text += (code == 3).to(torch.uint8) * 11
    del code
    text[line_bases :: line_bases + 1] = NEWLINE
    if n_bytes:
        text[-1] = NEWLINE
    out = text.cpu().numpy()
    del text
    out.setflags(write=False)
    return out


def line_start(index: int, line_bases: int) -> int:
    return index * (line_bases + 1)


def substitute(pattern: bytes, n_subs: int, rng: np.random.Generator) -> bytes:
    """``pattern`` with ``n_subs`` bases at distinct positions replaced by
    one of the three other bases."""
    out = bytearray(pattern)
    for pos in rng.choice(len(out), size=min(n_subs, len(out)), replace=False):
        others = [b for b in BASES if b != out[pos]]
        out[pos] = others[int(rng.integers(len(others)))]
    return bytes(out)


def plant_lines(text: np.ndarray, line_bases: int, lines: Sequence[int],
                every_bytes: int, max_subs: int, seed: int) -> np.ndarray:
    """A copy of ``text`` in which each of ``lines`` is copied over one
    whole line in ``every_bytes`` (at lines drawn from ``seed``), each copy
    with 0 to ``max_subs`` substitutions: the repeats that make a probe
    panel hit. The source lines themselves are never overwritten."""
    rng = stream(seed, 3)
    width = line_bases + 1
    n_lines = len(text) // width
    src = np.asarray(lines, dtype=np.int64)
    per_line = len(text) // every_bytes
    which = np.repeat(np.arange(len(src)), per_line)
    dst = rng.integers(n_lines, size=len(which))
    rows = np.asarray(text[: n_lines * width]).reshape(n_lines, width)
    copies = rows[src[which], :line_bases].copy()
    # 0 to max_subs substitutions a copy, at distinct positions, each base
    # replaced by one of the three others
    n_subs = rng.integers(max_subs + 1, size=len(which))
    pos = np.argsort(rng.random((len(which), line_bases)), axis=1)[:, :max_subs]
    code = np.full(256, -1, dtype=np.int64)
    code[np.frombuffer(BASES, np.uint8)] = np.arange(4)
    bases = np.frombuffer(BASES, np.uint8)
    for s in range(max_subs):
        at = np.nonzero(n_subs > s)[0]
        old = code[copies[at, pos[at, s]]]
        copies[at, pos[at, s]] = bases[(old + rng.integers(1, 4, size=len(at))) % 4]
    keep = ~np.isin(dst, src)
    out = np.array(text)
    out[: n_lines * width].reshape(n_lines, width)[dst[keep], :line_bases] = copies[keep]
    out.setflags(write=False)
    return out


def cut_patterns(text: np.ndarray, line_bases: int, cuts: Sequence[dict],
                 max_subs: int, rng: np.random.Generator) -> List[bytes]:
    """Patterns cut from ``text``: for each ``{"length": L, "count": c}``,
    ``c`` cuts of ``L`` bytes. A cut no longer than a line lies inside one
    line (a whole line at ``L == line_bases``), a longer one at any offset.
    Each cut gets 0 to ``max_subs`` substitutions."""
    n_lines = len(text) // (line_bases + 1)
    out = []
    for cut in cuts:
        length = int(cut["length"])
        for _ in range(int(cut["count"])):
            if length <= line_bases:
                at = (line_start(int(rng.integers(n_lines)), line_bases)
                      + int(rng.integers(line_bases - length + 1)))
            else:
                at = int(rng.integers(len(text) - length + 1))
            pat = bytes(text[at: at + length])
            out.append(substitute(pat, int(rng.integers(max_subs + 1)), rng))
    return out


def panel(text: np.ndarray, line_bases: int, entries: Sequence[dict]) -> List[bytes]:
    """A fixed pattern panel: ``{"line": i}`` is line ``i`` of ``text``
    (its bases, no newline); ``{"fill": "Q", "length": L}`` is ``L`` copies
    of one byte."""
    out = []
    for e in entries:
        if "line" in e:
            at = line_start(int(e["line"]), line_bases)
            out.append(bytes(text[at: at + line_bases]))
        else:
            out.append(e["fill"].encode("ascii") * int(e["length"]))
    return out


def contigs(pool: np.ndarray, sizes: Sequence[int], rng: np.random.Generator) -> List[np.ndarray]:
    """Read-only views of ``pool`` of the given sizes, in an order and at
    offsets drawn from ``rng``: every call carries the same sizes."""
    order = rng.permutation(len(sizes))
    out = []
    for i in order:
        size = int(sizes[i])
        at = int(rng.integers(len(pool) - size + 1))
        out.append(pool[at: at + size])
    return out
