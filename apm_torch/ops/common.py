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
    host-to-device copy). The native fold (``apmio_fold``, one pass of
    overlapping copies) does the work; :func:`fold_corpus_ref` is its plain
    NumPy version, which the tests hold it against.
    """
    from ..utils import native

    return native.fold(buf, offset, n_rows, wf, halo, out=out)


def fold_corpus_ref(
    buf: np.ndarray,
    offset: int,
    n_rows: int,
    wf: int,
    halo: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """:func:`fold_corpus` in NumPy: the rows that lie wholly inside the
    corpus are copied as one overlapping strided view, the few that reach
    past EOF are zero-padded one by one."""
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


def cap_for(k: int) -> int:
    """DP clamp value. ``min(dist, k+1)`` preserves the ``dist <= k`` verdict.

    Clamping commutes with the min-plus Levenshtein recurrence: if every
    input cell holds ``min(true, k+1)``, then ``min(min3(inputs)+cost,
    k+1)`` equals ``min(true_output, k+1)`` (monotonicity of min and plus),
    so every DP cell stays in ``[0, k+1]`` whatever the pattern length.
    """
    return k + 1


def pad_corpus(buf: np.ndarray, n_pad: int, halo: int) -> np.ndarray:
    """Zero-pad the corpus to ``n_pad + halo`` bytes (the reference
    engine's block layout)."""
    out = np.zeros(n_pad + halo, dtype=np.uint8)
    out[: len(buf)] = buf
    return out
