"""Golden NumPy oracles reproducing the reference sequential semantics.

NumPy copy of ``apm/utils/oracle.py``, kept here so that the port imports
without JAX; ``tests/test_torch_host.py`` holds the two copies equal.

These are the conformance authority for every engine in this package. Two
independent oracles are provided and cross-checked against each other in the
test suite:

* :func:`count_matches_reference` — a literal transcription of the sequential
  C semantics (reference ``src/sequential.c:104-144`` window loop and
  ``src/utils.c:76-99`` single-column square Levenshtein DP). O(n * m^2) per
  pattern; only usable on small inputs.
* :func:`count_matches` — a vectorized *banded* formulation (band |y-x| <= k,
  all DP cells clamped at k+1). Mathematically equivalent for the
  ``distance <= k`` predicate and fast enough to produce golden counts for the
  full ``dna/`` corpus. This is also the exact recurrence the banded-DP
  kernel (``apm_torch/csrc/dp_band.cu``) implements, expressed in NumPy.

Reference semantics being reproduced (quirks included, see SURVEY.md §0):

* window starts ``j`` range over ``0 <= j < n_bytes - k`` — the loop bound
  subtracts the approx factor, *not* the pattern length
  (``sequential.c:121``);
* near EOF the window is truncated: ``size = min(m, n - j)`` and the *pattern
  prefix* of that length is compared against the equally truncated text tail
  (``sequential.c:131-134``) — a documented reference quirk that inflates
  counts, reproduced here for byte-for-byte parity;
* the distance is the plain (unweighted) Levenshtein distance between two
  equal-length strings (``utils.c:76-99``); a window matches iff
  ``distance <= k`` (``sequential.c:138-140``).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Union

import numpy as np

Bytes = Union[bytes, bytearray, np.ndarray, str]


def as_u8(data: Bytes) -> np.ndarray:
    """Coerce text/pattern input to a 1-D uint8 byte array (raw bytes)."""
    if isinstance(data, np.ndarray):
        if data.dtype.kind in ("S", "U"):  # byte/str-typed arrays
            # Only a scalar / single element is unambiguous: 'S' items carry
            # NUL padding to the itemsize and multi-element 'U' arrays have
            # no defined byte concatenation — reject rather than mangle.
            if data.size > 1:
                raise ValueError(
                    "multi-element string arrays are ambiguous; join the "
                    "elements or pass bytes"
                )
            if data.size == 0:
                return np.zeros((0,), dtype=np.uint8)
            item = data.reshape(()).item()  # bytes for 'S', str for 'U'
            if isinstance(item, str):
                item = item.encode("latin-1")
            return np.frombuffer(item, dtype=np.uint8)
        if (
            data.dtype == np.uint8
            and data.ndim == 1
            and data.flags.c_contiguous
        ):
            # Identity-preserving fast path: callers never mutate the
            # result, so no copy is needed.
            return data
        return np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if isinstance(data, str):
        data = data.encode("latin-1")
    return np.frombuffer(bytes(data), dtype=np.uint8)


def levenshtein_square(s1: Bytes, s2: Bytes) -> int:
    """Edit distance between two equal-length strings.

    Literal transcription of the reference single-column DP
    (``src/utils.c:76-99``, MIN3 of deletion / insertion / substitution).
    """
    a = as_u8(s1)
    b = as_u8(s2)
    if len(a) != len(b):
        raise ValueError("levenshtein_square requires equal-length inputs")
    n = len(a)
    column = np.arange(n + 1, dtype=np.int64)
    for x in range(1, n + 1):
        column[0] = x
        lastdiag = x - 1
        for y in range(1, n + 1):
            olddiag = column[y]
            column[y] = min(
                column[y] + 1,
                column[y - 1] + 1,
                lastdiag + (0 if a[y - 1] == b[x - 1] else 1),
            )
            lastdiag = olddiag
    return int(column[n])


def count_matches_reference(corpus: Bytes, patterns: Sequence[Bytes], k: int) -> List[int]:
    """Literal, slow transcription of ``sequential.c``'s main loop.

    For each pattern: slide ``j`` over ``[0, n - k)``, truncate both pattern
    and text to ``size = min(m, n - j)``, count windows with distance <= k.
    """
    buf = as_u8(corpus)
    n = len(buf)
    out: List[int] = []
    for pat in patterns:
        p = as_u8(pat)
        m = len(p)
        cnt = 0
        for j in range(n - k):
            size = min(m, n - j)
            d = levenshtein_square(p[:size], buf[j : j + size])
            if d <= k:
                cnt += 1
        out.append(cnt)
    return out


def banded_distances(corpus: Bytes, pattern: Bytes, k: int) -> np.ndarray:
    """Clamped distances ``min(dist_j, k+1)`` for every window start ``j``.

    Vectorized over all ``n - k`` window starts at once. Maintains the DP band
    ``B[d] = D[x][x+d]`` for ``d in [-k, k]`` with every cell clamped at
    ``CAP = k + 1``; clamping commutes with the min-plus recurrence, so the
    returned value is exactly ``min(true_distance, k+1)`` and the predicate
    ``dist <= k`` is preserved.
    """
    buf = as_u8(corpus)
    p = as_u8(pattern)
    n = len(buf)
    m = len(p)
    nw = n - k
    if nw <= 0:
        return np.zeros((0,), dtype=np.int32)
    cap = np.int32(k + 1)
    w = np.arange(nw, dtype=np.int64)
    size = np.minimum(m, n - w)  # per-window truncated length, >= 1

    # Pad text so step reads past EOF are in-bounds (their cells are garbage
    # that can never influence a captured result — see SURVEY.md §7).
    bufp = np.concatenate([buf, np.zeros(m, dtype=np.uint8)])
    # Pad pattern by k on both sides so index y-1+k is always in range.
    ppad = np.concatenate([np.zeros(k, np.uint8), p, np.zeros(k, np.uint8)])

    band = np.full((2 * k + 1, nw), cap, dtype=np.int32)
    for d in range(0, k + 1):
        band[k + d, :] = d  # row x=0: D[0][y] = y, y = d
    res = np.full(nw, cap, dtype=np.int32)

    for x in range(1, m + 1):
        tx = bufp[w + (x - 1)]
        new = np.empty_like(band)
        prev = np.full(nw, cap, dtype=np.int32)  # insertion chain B_x[d-1]
        for d in range(-k, k + 1):
            y = x + d
            pc = ppad[y - 1 + k]
            c = (tx != pc).astype(np.int32)
            sub = band[k + d] + c
            dele = (band[k + d + 1] if d < k else np.full(nw, cap, np.int32)) + 1
            v = np.minimum(np.minimum(sub, dele), prev + 1)
            if y == 0:
                # boundary column D[x][0] = x (only reachable when x <= k)
                v = np.full(nw, x, dtype=np.int32)
            v = np.minimum(v, cap)
            new[k + d] = v
            prev = v
        band = new
        res = np.where(size == x, band[k], res)
    return res


def count_matches(corpus: Bytes, patterns: Sequence[Bytes], k: int) -> List[int]:
    """Fast golden counts: number of windows with distance <= k per pattern."""
    return [int(np.sum(banded_distances(corpus, p, k) <= k)) for p in patterns]
