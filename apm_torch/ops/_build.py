"""Build and load the port's two native libraries.

* The CUDA kernels (:func:`library`): every ``apm_torch/csrc/*.cu`` file is
  compiled by its own ``nvcc``, all in parallel, for Hopper (``sm_90a``),
  and linked into one shared library with a plain C interface.
* The host layer (:func:`host_library`): ``apm_torch/csrc/host/apmio.cpp``
  (the fold, file reads, the EOF-tail verifier and the cache hash),
  compiled by ``g++`` with the flags of the JAX package's
  ``native/Makefile``. It lives in a subdirectory, so the ``nvcc`` build
  does not see it.

Both are loaded with ``ctypes``, keyed by a hash of their sources and flags
and kept under ``apm_torch/_build/`` (listed in ``.gitignore``), so a second
process reuses them. Each is built at first use, never at import: importing
the package needs no compiler. A build goes through a temporary directory
and an atomic rename, so processes that build at once each see a whole
library or none.

A missing compiler or a failed build raises with the compiler's output;
there is no fallback to the plain PyTorch versions or to NumPy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
HOST_SRC = CSRC / "host" / "apmio.cpp"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the apm_torch CUDA kernels are built from "
        "apm_torch/csrc at first use and need the CUDA toolkit"
    )


def build() -> Path:
    """Compile the kernels if no library for the current sources exists.

    Every source is compiled to an object by its own ``nvcc``, all started
    together, then linked into one shared library. Returns the library
    path. The compilers' output (``-Xptxas -v``: registers, shared memory
    and spills per kernel) is kept beside it as ``<name>.log``.
    """
    lib = BUILD_DIR / f"libapm_torch_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((cmd, obj, proc))
        log, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(tmpdir, lib.name)
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        lib.with_suffix(".log").write_text("".join(log) + proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def build_log() -> str:
    """The ``nvcc`` output of the current library's build ("" if it was
    built by another copy of the sources)."""
    log = build().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.apm_dp_band_count.argtypes = [
        p, i64, i64,  # rows, n_rows, row_stride
        p, i32, i64, p,  # pat, n_pat, pat_stride, plens
        i32, i32,  # k, ke
        i64, i64, p, i64,  # wf, bound, dbound, start
        p, p, i32, p,  # out, scratch, grid, stream
    ]
    lib.apm_dp_band_count.restype = i32
    lib.apm_dp_band_batch.argtypes = [
        p, i64, i64,  # rows, n_rows, row_stride
        p, i32, i64, p,  # pat, n_pat, pat_stride, plens
        i32, i32, i64,  # k, ke, wf
        p, p, i64,  # meta, out, out_stride
        p, i32, p,  # scratch, grid, stream
    ]
    lib.apm_dp_band_batch.restype = i32
    lib.apm_dp_band_mask.argtypes = [
        p, i64, i64,  # rows, n_rows, row_stride
        p, i32, i64, p,  # pat, n_pat, pat_stride, plens
        i32, i32,  # k, ke
        i64, i64, p, i64,  # wf, bound, dbound, start
        p, p, i64,  # out, mask, mask_stride
        p, i32, p,  # scratch, grid, stream
    ]
    lib.apm_dp_band_mask.restype = i32
    lib.apm_dp_band_dyn.argtypes = [
        p, i64, i64,  # rows, n_rows, row_stride
        p, i32, i64, p,  # pat, n_pat, pat_stride, plens (device)
        i32, i32, i64,  # k, ke, wf
        i64, p, i64, p,  # bound, dbound, start, dstart
        p, p, i32, p,  # out, scratch, grid, stream
    ]
    lib.apm_dp_band_dyn.restype = i32
    lib.apm_dp_band_reg_max.argtypes = []
    lib.apm_dp_band_reg_max.restype = i32
    lib.apm_corr_fused_count.argtypes = [
        p, i64, i64, i64,  # rows, n_staged, row_stride, n_rows
        p, i32, i64, p, p,  # pat, n_pat, pat_stride, plens, prefix
        i64, i64, i64,  # wf, bound, start
        p, i32, p,  # out, grid, stream
    ]
    lib.apm_corr_fused_count.restype = i32
    lib.apm_corr_batch_count.argtypes = [
        p, i64, i64,  # rows, n_staged, row_stride
        p, i32, i64, p, p,  # pat, n_pat, pat_stride, plens, prefix
        i64, p, i32,  # wf, limits, fold
        p, i64, i32, p,  # out, out_stride, grid, stream
    ]
    lib.apm_corr_batch_count.restype = i32
    lib.apm_empty_launch.argtypes = [i32, i32, p]  # grid, threads, stream
    lib.apm_empty_launch.restype = i32
    lib.apm_pieces_fused_count.argtypes = [
        p, i64, i64, i64,  # rows, n_staged, row_stride, n_rows
        p, i32, i32, p, p, p,  # piece, n_piece, piece_stride, plen, owner, prefix
        i32, i32,  # pat0, n_pat
        i64, i64, i64,  # wf, bound, start
        p, p, i64,  # fcnt, rowmap, rowmap_stride
        i32, p,  # grid, stream
    ]
    lib.apm_pieces_fused_count.restype = i32
    myers_head = [
        p, i64, i64,  # rows, n_rows, row_stride
        p, i32, i32, i32, p, p,  # peq, n_pat, m_max, n_chan, alph, plens
        i32, i64,  # k, wf
    ]
    lib.apm_dp_myers_count.argtypes = myers_head + [
        i64, p, i64,  # bound, dbound, start
        p, i32, p,  # out, grid, stream
    ]
    lib.apm_dp_myers_count.restype = i32
    lib.apm_dp_myers_batch.argtypes = myers_head + [
        p, p, i64,  # meta, out, out_stride
        i32, p,  # grid, stream
    ]
    lib.apm_dp_myers_batch.restype = i32
    lib.apm_dp_myers_mask.argtypes = myers_head + [
        i64, p, i64,  # bound, dbound, start
        p, p, i64,  # out, mask, mask_stride
        i32, p,  # grid, stream
    ]
    lib.apm_dp_myers_mask.restype = i32
    lib.apm_dp_mask_grid.argtypes = [i64, i64, i32]  # n_rows, wf, ke (< 0: Myers)
    lib.apm_dp_mask_grid.restype = i32
    lib.apm_filter_pieces_count.argtypes = [
        p, i64, i64,  # rows, n_rows, row_stride
        p, i32, i64, i32,  # pchar, n_pat, pchar_stride, pad
        p, i32, p,  # pieces, n_piece, pstart
        i64, i64, i64,  # wf, bound, start
        p, p, i64,  # fcnt, rowmap, rowmap_stride
        i32, i32, i64,  # item_rows, threads, slot (filter_kernel.item_rows)
        p,  # stream
    ]
    lib.apm_filter_pieces_count.restype = i32
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def find_gxx() -> str:
    """Path of the host compiler: ``$CXX`` if set, else ``g++``, looked up
    on ``PATH``."""
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found ($CXX, PATH); the apm_torch host library is built "
            f"from {HOST_SRC.relative_to(_PKG.parent)} at first use and needs a "
            "C++17 compiler"
        )
    return cxx


def host_build() -> Path:
    """Compile the host layer if no library for the current source and
    flags exists; returns the library path."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(HOST_SRC.read_bytes())
    lib = BUILD_DIR / f"libapmio_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = find_gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, lib.name)
        cmd = [cxx, *HOST_FLAGS, str(HOST_SRC), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """The loaded host library, built on first call. Its calls release
    the GIL (``ctypes.CDLL``), so a fold, a hash or a tail count on one
    thread runs beside Python on another."""
    lib = ctypes.CDLL(str(host_build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    s = ctypes.c_char_p
    lib.apmio_file_size.argtypes = [s]
    lib.apmio_file_size.restype = i64
    lib.apmio_read_file.argtypes = [s, p, i64]  # path, out, size
    lib.apmio_read_file.restype = i64
    lib.apmio_read_range.argtypes = [s, i64, i64, p]  # path, start, len, out
    lib.apmio_read_range.restype = i32
    # src, src_len, offset, n_rows, wf, halo, out
    lib.apmio_fold.argtypes = [p, i64, i64, i64, i64, i64, p]
    lib.apmio_fold.restype = i32
    # path, offset, n_rows, wf, halo, out
    lib.apmio_read_folded.argtypes = [s, i64, i64, i64, i64, p]
    lib.apmio_read_folded.restype = i32
    # text, text_len, pat, m, k, n_windows, truncate_at, out_count
    lib.apmio_banded_count.argtypes = [p, i64, p, i64, i64, i64, i64, p]
    lib.apmio_banded_count.restype = i32
    # text, text_len, pats, offsets, n_pats, k, n_windows, truncate_at, out
    lib.apmio_banded_count_set.argtypes = [p, i64, p, p, i64, i64, i64, i64, p]
    lib.apmio_banded_count_set.restype = i32
    lib.apmio_hash.argtypes = [p, i64]
    lib.apmio_hash.restype = ctypes.c_uint64
    lib.apmio_hash_par.argtypes = [p, i64, i32]  # buf, n, threads
    lib.apmio_hash_par.restype = ctypes.c_uint64
    return lib
