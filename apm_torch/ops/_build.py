"""Build and load the port's CUDA kernels.

Every ``apm_torch/csrc/*.cu`` file is compiled by ``nvcc`` into one shared
library with a plain C interface, for Hopper (``sm_90a``), and loaded with
``ctypes``. The library is keyed by a hash of the sources and flags and
kept under ``apm_torch/_build/`` (listed in ``.gitignore``), so a second
process reuses it. The build runs at first use, never at import: importing
the package needs no compiler.

A missing ``nvcc`` or a failed build raises with the compiler's output;
there is no fallback to the plain PyTorch versions.
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
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


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

    Returns the library path. The compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it as
    ``<name>.log``.
    """
    lib = BUILD_DIR / f"libapm_torch_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
        i64, i64, i64,  # wf, bound, start
        p, p, i32, p,  # out, scratch, grid, stream
    ]
    lib.apm_dp_band_count.restype = i32
    lib.apm_dp_band_reg_max.argtypes = []
    lib.apm_dp_band_reg_max.restype = i32
    lib.apm_corr_fused_count.argtypes = [
        p, i64, i64, i64,  # rows, n_staged, row_stride, n_rows
        p, i32, i64, p,  # pat, n_pat, pat_stride, plens
        i64, i64, i64,  # wf, bound, start
        p, i32, p,  # out, grid, stream
    ]
    lib.apm_corr_fused_count.restype = i32
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
