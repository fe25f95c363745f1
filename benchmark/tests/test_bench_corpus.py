"""The generators: byte for byte under one seed, other bytes under another,
the shapes the configurations state."""

import numpy as np
import pytest

from benchmark import corpus as gen
from benchmark.workload import WARM, Workload

BIG_SEED = 2**31 + 2**30 + 12345  # past 32 signed bits, as the driver's seeds are


def test_dna_lines_repeat_and_shape():
    a = gen.dna_lines(10_000, 50, BIG_SEED, "cpu")
    b = gen.dna_lines(10_000, 50, BIG_SEED, "cpu")
    c = gen.dna_lines(10_000, 50, BIG_SEED + 1, "cpu")
    assert a.dtype == np.uint8 and not a.flags.writeable
    assert a.tobytes() == b.tobytes() and a.tobytes() != c.tobytes()
    lines = a.tobytes().split(b"\n")
    assert lines[-1] == b"" and all(len(x) == 50 for x in lines[:-2])
    assert 0 < len(lines[-2]) <= 50 and set(a.tobytes()) == set(b"ACGT\n")
    counts = np.bincount(a, minlength=256)[list(b"ACGT")]
    assert counts.min() > 0.2 * counts.sum()  # about a quarter each


def test_cut_patterns_lie_in_lines_and_carry_substitutions():
    text = gen.dna_lines(51 * 400, 50, 7, "cpu")
    rng = gen.stream(7, 1, 0)
    pats = gen.cut_patterns(text, 50, [{"length": 32, "count": 1}, {"length": 50, "count": 5}],
                            0, rng)
    assert [len(p) for p in pats] == [32, 50, 50, 50, 50, 50]
    raw = text.tobytes()
    assert all(p in raw and b"\n" not in p for p in pats)
    subbed = gen.cut_patterns(text, 50, [{"length": 50, "count": 40}], 3, gen.stream(7, 1, 1))
    assert all(set(p) <= set(b"ACGT") for p in subbed)
    assert any(p not in raw for p in subbed)  # some carry substitutions


@pytest.mark.parametrize("cell", ["stream_k3", "batch_k1"])
def test_requests_repeat_under_a_seed(cell):
    config = {"corpus": {"bytes": 120_000, "line_bases": 50,
                         "plant": {"lines": [5, 10], "every_bytes": 4096, "max_substitutions": 2}},
              "panel": [{"fill": "Q", "length": 32}, {"line": 5}, {"line": 10}]}
    if cell == "batch_k1":
        config["contigs"] = {"sizes": [60, 1327, 3000, 9000]}
        traffic = {"call": "count_batch", "k": 1, "patterns": "panel"}
    else:
        traffic = {"call": "count", "k": 3, "patterns": {
            "cut": [{"length": 32, "count": 1}, {"length": 50, "count": 5}],
            "substitutions_max": 3, "fresh": True}}

    def take(seed):
        w = Workload(config, traffic, seed, "cpu")
        return [(r.patterns, [c.tobytes() for c in r.corpora])
                for r in (w.request(0), w.request(1), w.request(WARM))]

    a, b, c = take(BIG_SEED), take(BIG_SEED), take(BIG_SEED + 1)
    assert a == b and a != c
    assert a[0] != a[1]  # each request is new


def test_contigs_are_read_only_views_of_the_stated_sizes():
    sizes = [1327, 132803, 183549, 1591301, 4000000]
    pool = gen.dna_lines(8 << 20, 50, 3, "cpu")
    a = gen.contigs(pool, sizes, gen.stream(3, 2, 0))
    b = gen.contigs(pool, sizes, gen.stream(3, 2, 1))
    assert sorted(len(v) for v in a) == sizes == sorted(len(v) for v in b)
    assert all(v.base is pool and not v.flags.writeable for v in a)
    assert [v.tobytes() for v in a] != [v.tobytes() for v in b]  # new content a call


@pytest.mark.parametrize("max_subs", [0, 1, 3])
def test_plants_copy_panel_lines(max_subs):
    text = gen.dna_lines(51 * 20_000, 50, 11, "cpu")
    planted = gen.plant_lines(text, 50, [5, 10], 2048, max_subs, 11)
    assert not planted.flags.writeable and planted.tobytes() != text.tobytes()
    # the source lines stay, and every line is still 50 bases and a newline
    assert planted[5 * 51: 5 * 51 + 50].tobytes() == text[5 * 51: 5 * 51 + 50].tobytes()
    assert planted[50::51].tobytes() == text[50::51].tobytes()
    assert set(planted.tobytes()) == set(b"ACGT\n")
    rows = planted[: 20_000 * 51].reshape(-1, 51)[:, :50]
    for src in (5, 10):
        line = text[src * 51: src * 51 + 50]
        dist = (rows != line).sum(axis=1)
        near = int((dist <= max_subs).sum()) - 1  # the source line itself
        # about one copy in 2048 bytes; a copy overwritten by another is lost
        assert 0.8 * len(text) // 2048 <= near <= len(text) // 2048
        assert int((dist == 0).sum()) - 1 < near or max_subs == 0
