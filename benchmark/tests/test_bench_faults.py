"""The check that decides ``correct``: it has to fail the control and a
timed path broken underneath, run after run (the look for a card skipped,
at a CPU test's size)."""

import numpy as np
import pytest
from bench_helpers import all_cells, control_in_the_programs_place

from benchmark import harness


def run_broken(root, cell, monkeypatch, count=None, count_batch=None):
    from apm_torch import Scanner

    if count:
        monkeypatch.setattr(Scanner, "count", count)
    if count_batch:
        monkeypatch.setattr(Scanner, "count_batch", count_batch)
    return harness.run_cell(root, cell, 2**31 + 7, 0.3, False, 0.0, device="cpu",
                            log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", all_cells())
def test_an_answer_altered_where_it_is_produced(tiny_root, cell, monkeypatch):
    from apm_torch import Scanner

    count, count_batch = Scanner.count, Scanner.count_batch

    def altered_count(self, corpus):
        out = count(self, corpus)
        out[-1] += 1
        return out

    def altered_batch(self, corpora):
        out = count_batch(self, corpora)
        out[len(out) // 2, 0] += 1
        return out

    out = run_broken(tiny_root, cell, monkeypatch, altered_count, altered_batch)
    assert out["correct"] is False and out["failed"] >= 1
    assert out["compared"]["mismatched_counts"]["value"] >= 1


@pytest.mark.parametrize("cell", [c for c in all_cells() if c.endswith(".batch_k1")])
def test_half_of_the_batch_left_out(tiny_root, cell, monkeypatch):
    from apm_torch import Scanner

    count_batch = Scanner.count_batch

    def half(self, corpora):
        out = np.zeros((len(corpora), len(self.patterns.raw)), dtype=np.int64)
        out[: len(corpora) // 2] = count_batch(self, corpora[: len(corpora) // 2])
        return out

    out = run_broken(tiny_root, cell, monkeypatch, count_batch=half)
    assert out["correct"] is False


@pytest.mark.parametrize("cell", all_cells())
def test_the_control_in_the_programs_place(tiny_root, cell, monkeypatch):
    """The reference with the EOF-truncated windows left out, as the
    program: ``correct`` comes out false, on more than the limit."""
    control_in_the_programs_place(monkeypatch, "cpu")
    out = harness.run_cell(tiny_root, cell, 2**31 + 11, 0.3, False, 0.0, device="cpu",
                           log=lambda *a, **k: None)
    assert out["correct"] is False
    compared = out["compared"]["mismatched_counts"]
    assert compared["value"] > compared["limit"] == 0
