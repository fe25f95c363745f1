"""On the card (``pytest -s -m cuda benchmark/tests`` there): every cell
runs and is correct at its own size, and the control, put in the
program's place at that size, makes ``correct`` false on three seeds.
Each control reading is printed as one JSON line."""

import json

import pytest
from bench_helpers import ROOT, cells, control_in_the_programs_place

from benchmark import harness

CONTROL_SEEDS = (2**31 + 2025, 2**31 + 2026, 2**31 + 2027)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_cell_runs_correct_on_the_card(card, cell):
    out = harness.run_cell(ROOT, cell, 2**31 + 2024, 2.0, False, 0.0,
                           log=lambda *a, **k: None)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
@pytest.mark.parametrize("cell", cells())
def test_control_makes_correct_false_on_the_card(card, cell, seed, monkeypatch):
    control_in_the_programs_place(monkeypatch, card)
    # a window long enough that the control answers as many requests as a
    # run of the cell compares
    want = int(spec_traffic(cell).get("check_calls", 4))
    out = harness.run_cell(ROOT, cell, seed, 0.0, False, 0.0, log=lambda *a, **k: None,
                           min_calls=want)
    compared = out["compared"]["mismatched_counts"]
    print(json.dumps({"control": cell, "seed": seed, "attempted": out["attempted"],
                      "mismatched_counts": compared["value"], "limit": compared["limit"]}))
    assert out["correct"] is False and compared["value"] > compared["limit"]


def spec_traffic(cell):
    from benchmark import spec

    return spec.find_cell(ROOT, cell).traffic
