"""The capture-panel deployment on the CPU: 120-byte probes at k = 12 over
one unwrapped FASTA line. The benchmark's long-pattern reference
(``benchmark/reference_long.py``) against the port's oracle and the
benchmark's one-word reference; the Scanner against that reference through
kernel D's banded tier on both phase-2 routes the cell can take; and the
counters of kernel D's and the overflow verify's work."""

import numpy as np
import pytest
import torch

from apm_torch import ApmConfig, Scanner
from apm_torch.ops import filter_kernel, fused
from apm_torch.utils.oracle import count_matches
from benchmark import corpus as gen
from benchmark import reference, reference_long

K = 12
CPU = dict(device="cpu", block_windows=1024)  # the cell's layout: rows of 128 windows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _panel(n, n_probes, seed, copies=3, max_subs=6):
    """One line of ``n`` bytes with ``n_probes`` probes of 120 bases cut from
    it (0 to K substitutions each), and ``copies`` planted near copies of
    each (0 to ``max_subs`` substitutions); the first probe's first copy is
    cut off by the end of the text."""
    text = gen.dna_lines(n, n - 1, seed, "cpu")
    probes = gen.cut_patterns(text, n - 1, [{"length": 120, "count": n_probes}], K,
                              gen.stream(seed, 1, 0))
    out = np.array(text)
    rng = np.random.default_rng(seed)
    for i, p in enumerate(probes):
        for c in range(copies):
            at = n - 61 if i == c == 0 else int(rng.integers(0, n - 300))
            copy = np.frombuffer(gen.substitute(p, int(rng.integers(max_subs + 1)), rng), np.uint8)
            end = min(n - 1, at + 120)
            out[at:end] = copy[: end - at]
    out.setflags(write=False)
    return out, probes


@pytest.mark.parametrize("seed", [1, 2])
def test_long_reference_equals_the_oracle_at_120(seed):
    """m = 120, k = 12 on a few KB, every window the oracle counts: near
    copies inside the text and one cut by its end (the EOF-truncated
    windows), and a second text that ends inside a copy."""
    text, probes = _panel(4000, 4, 10 + seed)
    texts = [text, text[: 4000 - 30]]
    want = [count_matches(t, probes, K) for t in texts]
    got = reference_long.count_many(texts, probes, K, "cpu")
    assert got.tolist() == want
    no_eof = reference_long.count_many(texts, probes, K, "cpu", eof=False)
    assert (no_eof <= got).all() and (no_eof != got).any()
    assert (got > 1).all()  # near copies: every probe counts above 1


@pytest.mark.parametrize("k", [0, 1, 3, 5, 12])
def test_long_reference_equals_the_word_reference(k):
    """Up to 62 bytes, where the one-word reference holds: the same counts,
    in both the pigeonhole and the every-window branch."""
    text = gen.dna_lines(20_000, 50, 30 + k, "cpu")
    pats = gen.cut_patterns(text, 50, [{"length": 32, "count": 2}, {"length": 50, "count": 3}],
                            k, gen.stream(30 + k, 1, 0))
    pats += [text[-40:-1].tobytes(), b"ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTAC"]
    texts = [text, text[:7001], text[100:150]]
    want = reference.count_many(texts, pats, k, "cpu")
    got = reference_long.count_many(texts, pats, k, "cpu")
    assert got.tolist() == want.tolist()
    assert reference_long.count_many(texts, pats, k, "cpu", eof=False).tolist() == \
        reference.count_many(texts, pats, k, "cpu", eof=False).tolist()


def test_long_distances_past_one_word():
    """The two-word recurrence at the lengths where the words meet, against
    the oracle's square DP, full and truncated."""
    from apm_torch.utils.oracle import levenshtein_square

    rng = np.random.default_rng(4)
    text = bytes(rng.integers(65, 69, 700, dtype=np.uint8))
    t = torch.from_numpy(np.frombuffer(text + bytes(128), np.uint8).copy())
    for m in (63, 64, 65, 120, 127, 128):
        pat = bytes(rng.integers(65, 69, m, dtype=np.uint8))
        starts = torch.arange(0, 500, 11)
        sizes = torch.tensor([1 + (i * 37) % m for i in range(len(starts))])
        got = reference_long.distances(t, starts, sizes, pat).tolist()
        assert got == [levenshtein_square(pat[:L], text[j: j + L])
                       for j, L in zip(starts.tolist(), sizes.tolist())]
        full = reference_long.distances(t, 5, torch.full((30,), m), pat).tolist()
        assert full == [levenshtein_square(pat, text[j: j + m]) for j in range(5, 35)]
    with pytest.raises(ValueError):
        reference_long.count_many([np.frombuffer(text, np.uint8)], [text[:129]], 3, "cpu")


@pytest.mark.parametrize("route", ["device-verify", "count_hot_batch"])
def test_scanner_equals_the_long_reference(route, monkeypatch):
    """8 probes of 120 bases over a 40 KB line through kernel D's banded
    tier. A hot-row bucket of 8 sends the hot rows to the overflow
    recovery, as the cell's bucket of 136 rows does at 256 MiB."""
    text, probes = _panel(40_000, 8, 5)
    assert {filter_kernel.tier_of(len(p), K) for p in probes} == {(7, 1)}
    if route == "count_hot_batch":
        monkeypatch.setattr(fused, "pick_max_hot", lambda *a: 8)
    sc = Scanner(probes, K, ApmConfig(**CPU))
    got = sc.count(text)
    assert sc.last_filtration["route"] == route
    assert sc.last_filtration["n_hot"] > 8
    want = reference_long.count_many([text], probes, K, "cpu")[0]
    assert got.tolist() == want.tolist()
    assert (want > 1).all()


@pytest.mark.parametrize("route", ["device-verify", "count_hot_batch"])
def test_the_work_counters(route, monkeypatch):
    """Traced, a call counts kernel D's piece windows (all banded here) and
    the rows of its item and, on the overflow route, the verify's windows
    and cells; untraced, none."""
    text, probes = _panel(30_000, 6, 8)
    if route == "count_hot_batch":
        monkeypatch.setattr(fused, "pick_max_hot", lambda *a: 8)
    sc = Scanner(probes, K, ApmConfig(**CPU))
    sc.count(text)
    assert not any(name.startswith("#") for name in sc.meter.last_spans)
    sc.meter.trace = True
    sc.count(text)
    s = sc.meter.last_spans
    assert sc.last_filtration["route"] == route
    owned = s["#windows"]
    assert owned == len(text) - 120 + 1  # one chunk, every full window
    assert s["#piece windows"] == owned * 7 * len(probes)
    assert s["#banded piece windows"] == s["#piece windows"]
    assert s["#filter item rows"] == 64  # one launch, 64 rows of 128 windows an item
    n_hot, wf = sc.last_filtration["n_hot"], 128
    if route == "count_hot_batch":
        assert s["#verify windows"] == n_hot * wf * len(probes)
        assert s["#verify cells"] == n_hot * wf * 120 * len(probes)
        assert s["count_hot_batch"] > 0
    else:
        assert "#verify windows" not in s and "#verify cells" not in s


def test_exact_tier_piece_windows():
    """k = 3 on a 32- and a 50-mer: four exact pieces each, none banded."""
    text = gen.dna_lines(20_000, 50, 9, "cpu")
    pats = [text[102:134].tobytes(), text[510:560].tobytes()]
    sc = Scanner(pats, 3, ApmConfig(**CPU))
    sc.meter.trace = True
    sc.count(text)
    s = sc.meter.last_spans
    assert s["#piece windows"] == s["#windows"] * 8
    assert s["#banded piece windows"] == 0
