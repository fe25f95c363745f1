"""ctypes binding of the port's native host layer (port of
``apm/utils/native.py``).

The library is ``apm_torch/csrc/host/apmio.cpp``, built with ``g++`` at
first use by :func:`apm_torch.ops._build.host_library`. Every function here
needs it: a missing compiler or a failed build raises, and there is no
NumPy fallback to switch to. Each call releases the GIL for its duration.
Arguments are checked here before any pointer reaches the C side.
"""

from __future__ import annotations

import ctypes
import errno
import os
from typing import Optional, Sequence, Tuple

import numpy as np


def _lib():
    from ..ops._build import host_library

    return host_library()


def _u8_1d(buf, what: str) -> np.ndarray:
    a = np.asarray(buf)
    if a.dtype != np.uint8 or a.ndim != 1:
        raise ValueError(f"{what} must be a 1-D uint8 array, got {a.dtype} {a.shape}")
    return a


def _rows_out(out: Optional[np.ndarray], n_rows: int, width: int) -> np.ndarray:
    if out is None:
        return np.empty((n_rows, width), dtype=np.uint8)
    if (
        out.shape != (n_rows, width) or out.dtype != np.uint8
        or not out.flags.c_contiguous or not out.flags.writeable
    ):
        raise ValueError(
            f"out must be a writable C-contiguous uint8 {(n_rows, width)}, got "
            f"{out.dtype} {out.shape}"
        )
    return out


def _check_fold_args(offset: int, n_rows: int, wf: int, halo: int) -> None:
    if offset < 0 or n_rows < 0 or wf <= 0 or halo < 0:
        raise ValueError(
            f"fold needs offset >= 0, n_rows >= 0, wf > 0, halo >= 0; got "
            f"{offset}, {n_rows}, {wf}, {halo}"
        )


def read_file(path) -> np.ndarray:
    """The whole file's bytes, newlines included (mmap and one copy)."""
    path = os.fspath(path)
    lib = _lib()
    size = lib.apmio_file_size(os.fsencode(path))
    if size < 0:
        raise FileNotFoundError(errno.ENOENT, os.strerror(errno.ENOENT), path)
    out = np.empty(size, dtype=np.uint8)
    got = lib.apmio_read_file(os.fsencode(path), out.ctypes.data, size)
    if got != size:
        raise OSError(f"short read from {path}: {got} != {size}")
    return out


def read_range(path, start: int, length: int) -> np.ndarray:
    """Bytes ``[start, start + length)`` of a file, zero-filled past EOF."""
    path = os.fspath(path)
    if start < 0 or length < 0:
        raise ValueError(f"read_range needs start, length >= 0; got {start}, {length}")
    out = np.empty(length, dtype=np.uint8)
    rc = _lib().apmio_read_range(os.fsencode(path), start, length, out.ctypes.data)
    if rc != 0:
        raise OSError(f"apmio_read_range failed for {path} [{start}, {start + length})")
    return out


def fold(
    buf: np.ndarray, offset: int, n_rows: int, wf: int, halo: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Stage ``buf`` into ``(n_rows, wf + halo)`` overlapping rows: row
    ``r`` is ``buf[offset + r*wf : offset + r*wf + wf + halo)``, zero-filled
    past EOF (``apmio_fold``). ``out``, when given, is the writable
    C-contiguous uint8 array the rows go into (the Scanner passes its
    page-locked staging rows). Only the bytes the rows read need to be
    contiguous: a strided ``buf`` is copied over that range alone."""
    _check_fold_args(offset, n_rows, wf, halo)
    out = _rows_out(out, n_rows, wf + halo)
    src = np.ascontiguousarray(_u8_1d(buf, "buf")[offset : offset + n_rows * wf + halo])
    rc = _lib().apmio_fold(src.ctypes.data, len(src), 0, n_rows, wf, halo, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"apmio_fold failed ({rc})")
    return out


def read_folded(
    path, offset: int, n_rows: int, wf: int, halo: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """:func:`fold` straight from a file (mmap of the rows' range only, no
    whole-file read)."""
    path = os.fspath(path)
    _check_fold_args(offset, n_rows, wf, halo)
    out = _rows_out(out, n_rows, wf + halo)
    rc = _lib().apmio_read_folded(os.fsencode(path), offset, n_rows, wf, halo, out.ctypes.data)
    if rc != 0:
        raise OSError(f"apmio_read_folded failed for {path}")
    return out


def banded_count(
    text: np.ndarray, pattern, k: int, n_windows: int, truncate_at: int = -1
) -> int:
    """Windows ``j in [0, n_windows)`` of ``text`` within banded Levenshtein
    distance ``k`` of ``pattern`` (``apmio_banded_count``). ``truncate_at
    >= 0`` applies the reference's EOF truncation, ``size = min(m,
    truncate_at - j)`` (pass the text's length when the text is the
    corpus's suffix). The same verdicts as
    :func:`apm_torch.utils.oracle.banded_distances`."""
    text = np.ascontiguousarray(_u8_1d(text, "text"))
    pat = np.ascontiguousarray(_u8_1d(pattern, "pattern"))
    if len(pat) == 0 or k < 0 or n_windows < 0:
        raise ValueError(
            f"banded_count needs a pattern, k >= 0, n_windows >= 0; got m = "
            f"{len(pat)}, k = {k}, n_windows = {n_windows}"
        )
    count = ctypes.c_int64(0)
    rc = _lib().apmio_banded_count(
        text.ctypes.data, len(text), pat.ctypes.data, len(pat), k, n_windows,
        truncate_at, ctypes.addressof(count),
    )
    if rc != 0:
        raise ValueError(f"apmio_banded_count failed ({rc})")
    return int(count.value)


def pattern_set(patterns: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """``patterns`` as :func:`banded_count_set` takes them: their bytes
    back to back (uint8) and ``len(patterns) + 1`` int64 offsets."""
    offsets = np.zeros((len(patterns) + 1,), dtype=np.int64)
    np.cumsum([len(p) for p in patterns], out=offsets[1:])
    return np.frombuffer(b"".join(patterns), np.uint8), offsets


def banded_count_set(
    text: np.ndarray, pats: np.ndarray, offsets: np.ndarray, k: int, n_windows: int,
    truncate_at: int = -1,
) -> np.ndarray:
    """:func:`banded_count` of every pattern of a set, in one native call
    (``apmio_banded_count_set``): pattern ``i`` is ``pats[offsets[i] :
    offsets[i + 1]]`` (:func:`pattern_set`). Returns ``(len(offsets) - 1,)``
    int64 counts."""
    text = np.ascontiguousarray(_u8_1d(text, "text"))
    pats = np.ascontiguousarray(_u8_1d(pats, "pats"))
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if (
        offsets.ndim != 1 or len(offsets) == 0 or offsets[0] != 0
        or offsets[-1] != len(pats) or (np.diff(offsets) <= 0).any()
    ):
        raise ValueError(
            f"banded_count_set needs offsets from 0 to len(pats) = {len(pats)}, each "
            f"pattern non-empty; got {offsets.tolist()}"
        )
    if k < 0 or n_windows < 0:
        raise ValueError(
            f"banded_count_set needs k >= 0, n_windows >= 0; got k = {k}, "
            f"n_windows = {n_windows}"
        )
    out = np.zeros((len(offsets) - 1,), dtype=np.int64)
    rc = _lib().apmio_banded_count_set(
        text.ctypes.data, len(text), pats.ctypes.data, offsets.ctypes.data,
        len(out), k, n_windows, truncate_at, out.ctypes.data,
    )
    if rc != 0:
        raise ValueError(f"apmio_banded_count_set failed ({rc})")
    return out


def hash_bytes(buf: np.ndarray) -> int:
    """Full-content 64-bit hash (MurmurHash64A mixing), in parallel stripes
    of at least 8 MB on up to 16 threads (``apmio_hash_par``)."""
    a = np.asarray(buf)
    if a.dtype != np.uint8:
        raise ValueError(f"hash_bytes takes uint8, got {a.dtype}")
    a = np.ascontiguousarray(a).reshape(-1)
    threads = min(16, os.cpu_count() or 1)
    return int(_lib().apmio_hash_par(a.ctypes.data, a.size, threads))
