"""apm_torch — approximate pattern matching on an NVIDIA GPU with PyTorch.

The PyTorch/CUDA port of the ``apm`` package: count, for each pattern, the
text windows whose Levenshtein distance to the pattern is <= k, with the
sequential C reference's semantics (EOF truncation included). The scan
kernels are hand-written CUDA for Hopper (``apm_torch/csrc``), built with
``nvcc`` at first use; each has a plain PyTorch version beside it. The
package imports ``torch`` and ``numpy`` and never JAX.
"""

__version__ = "0.1.0"

from .utils import ApmConfig, PatternSet, read_input_file
from .models.scanner import Scanner, scan_counts

__all__ = [
    "ApmConfig",
    "PatternSet",
    "Scanner",
    "scan_counts",
    "read_input_file",
    "__version__",
]
