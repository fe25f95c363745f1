"""Corpus and pattern ingestion (port of ``apm/utils/io.py``).

The reference slurps the database file raw — including newline bytes, no FASTA
parsing (``src/utils.c:12-68``) — and takes patterns as case-sensitive byte
strings from argv (``src/sequential.c:61-77``). We reproduce both behaviours.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import numpy as np

from .oracle import as_u8

Bytes = Union[bytes, bytearray, np.ndarray, str]


def read_input_file(path: Union[str, os.PathLike]) -> np.ndarray:
    """Whole-file raw byte slurp, the moral equivalent of ``utils.c:12-68``.

    Returns a 1-D uint8 array of exactly the file's bytes (newlines
    included), read by the native mmap loader (:func:`apm_torch.utils.
    native.read_file`).
    """
    from . import native

    return native.read_file(path)


@dataclass(frozen=True)
class PatternSet:
    """A padded, vectorization-ready pattern table.

    Replaces the reference's per-pattern ``char*`` + ``strlen`` plumbing with
    a dense ``(P, max_m)`` uint8 table plus a length vector; engines mask by
    length. ``raw`` keeps the original byte strings for output formatting
    (``sequential.c:157-160`` echoes the pattern verbatim).
    """

    table: np.ndarray  # (P, max_m) uint8, zero-padded
    lengths: np.ndarray  # (P,) int32
    raw: Tuple[bytes, ...]

    @property
    def num_patterns(self) -> int:
        return int(self.table.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.table.shape[1])

    @staticmethod
    def from_patterns(patterns: Sequence[Bytes]) -> "PatternSet":
        if len(patterns) == 0:
            raise ValueError("at least one pattern is required")
        arrs = [as_u8(p) for p in patterns]
        for i, a in enumerate(arrs):
            if len(a) == 0:
                # mirrors sequential.c:65-68 (empty pattern is a usage error)
                raise ValueError(f"pattern {i} is empty")
        max_m = max(len(a) for a in arrs)
        table = np.zeros((len(arrs), max_m), dtype=np.uint8)
        lengths = np.zeros((len(arrs),), dtype=np.int32)
        for i, a in enumerate(arrs):
            table[i, : len(a)] = a
            lengths[i] = len(a)
        return PatternSet(table=table, lengths=lengths, raw=tuple(bytes(a.tobytes()) for a in arrs))

    def packed(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pattern table padded by ``k`` columns on each side.

        Engines index pattern position ``y - 1`` for band offsets
        ``d in [-k, k]`` with ``y = x + d``; the symmetric pad keeps the index
        ``y - 1 + k`` in ``[0, max_m + 2k)`` without branching.
        """
        if k < 0:
            raise ValueError("approx factor k must be >= 0")
        p = self.num_patterns
        padded = np.zeros((p, self.max_len + 2 * k), dtype=np.uint8)
        padded[:, k : k + self.max_len] = self.table
        return padded, self.lengths.copy()
