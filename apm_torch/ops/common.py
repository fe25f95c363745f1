"""Shared helpers for the scan engines (port of ``apm/ops/common.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fold_corpus(
    buf: np.ndarray,
    offset: int,
    n_rows: int,
    wf: int,
    halo: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Stage the corpus into overlapping rows for the scan kernels.

    Row ``r`` holds bytes ``buf[offset + r*wf : offset + r*wf + wf + halo)``,
    zero-padded past EOF — the same rows ``apm``'s ``fold_corpus`` builds,
    so both packages' kernels see identical inputs. ``out``, when given, is
    a C-contiguous ``(n_rows, wf + halo)`` uint8 array the rows are written
    into (the Scanner passes page-locked staging memory for an asynchronous
    host-to-device copy).

    Rows that lie wholly inside the corpus are copied straight from it as
    one overlapping strided view (one pass, no intermediate buffer); only
    the few rows that reach past EOF are zero-padded one by one.
    """
    width = wf + halo
    if out is None:
        out = np.empty((n_rows, width), dtype=np.uint8)
    elif out.shape != (n_rows, width) or out.dtype != np.uint8:
        raise ValueError(
            f"out must be uint8 {(n_rows, width)}, got {out.dtype} {out.shape}"
        )
    src = np.ascontiguousarray(buf[offset : offset + n_rows * wf + halo])
    n = len(src)
    n_full = 0 if n < width else min(n_rows, (n - width) // wf + 1)
    n_data = min(n_rows, -(-n // wf))  # rows that start inside the corpus
    if n_full:
        np.copyto(
            out[:n_full],
            np.lib.stride_tricks.as_strided(
                src, shape=(n_full, width), strides=(wf, 1), writeable=False
            ),
        )
    for r in range(n_full, n_data):
        seg = src[r * wf : r * wf + width]
        out[r, : len(seg)] = seg
        out[r, len(seg) :] = 0
    out[max(n_full, n_data) :] = 0
    return out
