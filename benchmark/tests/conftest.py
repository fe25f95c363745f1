"""The benchmark's CPU tests: ``pytest benchmark/tests`` from the root.

The root goes on ``sys.path`` so that ``benchmark`` and ``apm_torch``
import as the run imports them. Card tests carry the ``cuda`` marker and
decide inside the test whether there is a card.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_helpers import shrink, with_candidates  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: several test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of BENCHMARK.json, with the candidate cells added
    (:func:`with_candidates`), and of the benchmark's folder, configurations
    shrunk (:func:`shrink`)."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = with_candidates(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shrink(root)
    return root
