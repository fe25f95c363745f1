"""The plain reference against a literal transcription of the reference C
program, and against apm_torch on small corpora, EOF tails included."""

import numpy as np
import pytest
import torch

from benchmark import reference


def levenshtein(a: bytes, b: bytes) -> int:
    """utils.c:76-99's square DP, literally."""
    n = len(a)
    col = list(range(n + 1))
    for x in range(1, n + 1):
        col[0], last = x, x - 1
        for y in range(1, n + 1):
            old = col[y]
            col[y] = min(col[y] + 1, col[y - 1] + 1, last + (a[y - 1] != b[x - 1]))
            last = old
    return col[n]


def literal_counts(text: bytes, patterns, k: int):
    """sequential.c's loop: j over [0, n - k), windows truncated at EOF."""
    n = len(text)
    out = []
    for p in patterns:
        c = 0
        for j in range(n - k):
            size = min(len(p), n - j)
            c += levenshtein(p[:size], text[j: j + size]) <= k
        out.append(c)
    return out


def random_case(rng, n_max=260, m_max=30):
    alphabet = b"ACGT\n"[: int(rng.integers(2, 6))]
    n = int(rng.integers(1, n_max))
    text = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))
    pats = []
    for _ in range(3):
        m = int(rng.integers(1, m_max))
        if n > m and rng.random() < 0.7:  # near copies, some at the very end
            at = n - m if rng.random() < 0.3 else int(rng.integers(0, n - m + 1))
            p = bytearray(text[at: at + m])
            for _ in range(int(rng.integers(0, 3))):
                p[int(rng.integers(m))] = alphabet[int(rng.integers(len(alphabet)))]
            pats.append(bytes(p))
        else:
            pats.append(bytes(alphabet[i] for i in rng.integers(0, len(alphabet), m)))
    return text, pats, int(rng.integers(0, 6))


@pytest.mark.parametrize("seed", range(8))
def test_reference_equals_the_literal_program(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        text, pats, k = random_case(rng)
        texts = [np.frombuffer(text, np.uint8), np.frombuffer(text[: len(text) // 2], np.uint8)]
        got = reference.count_many(texts, pats, k, "cpu")
        want = [literal_counts(t.tobytes(), pats, k) for t in texts]
        assert got.tolist() == want, (text, pats, k)


def test_distances_up_to_the_word():
    rng = np.random.default_rng(5)
    for m in (1, 7, 31, 50, 62):
        text = bytes(rng.integers(65, 69, 400, dtype=np.uint8))
        pat = bytes(rng.integers(65, 69, m, dtype=np.uint8))
        t = torch.from_numpy(np.frombuffer(text + bytes(m), np.uint8).copy())
        starts = torch.arange(0, 300, 7)
        sizes = torch.tensor([1 + (i % m) for i in range(len(starts))])
        got = reference.distances(t, starts, sizes, pat).tolist()
        want = [levenshtein(pat[:L], text[j: j + L]) for j, L in zip(starts.tolist(), sizes.tolist())]
        assert got == want
        full = reference.distances(t, 3, torch.full((50,), m), pat).tolist()
        assert full == [levenshtein(pat, text[j: j + m]) for j in range(3, 53)]


def test_control_breaks_the_eof_guarantee():
    from benchmark import corpus as gen

    text = gen.dna_lines(3000, 50, 3, "cpu")
    pats = [text[102:152].tobytes(), text[510:542].tobytes()]
    full = reference.count_many([text], pats, 3, "cpu")
    no_eof = reference.count_many([text], pats, 3, "cpu", eof=False)
    assert (no_eof <= full).all() and (no_eof != full).any()


@pytest.mark.parametrize("k", [0, 1, 3, 12])
def test_reference_agrees_with_apm_torch(k):
    """apm_torch's Scanner on the CPU (its plain versions) against the
    reference, on the cells' line format with planted near copies."""
    from apm_torch import ApmConfig, Scanner

    from benchmark import corpus as gen

    text = gen.dna_lines(30_000, 50, 40 + k, "cpu")
    rng = gen.stream(40 + k, 1, 0)
    pats = gen.cut_patterns(text, 50, [{"length": 32, "count": 1}, {"length": 50, "count": 5}],
                            k, rng)
    texts = [text, text[: 20_011], text[5: 9_000]]
    want = reference.count_many(texts, pats, k, "cpu")
    sc = Scanner(pats, k, ApmConfig(device="cpu"))
    assert sc.count(text).tolist() == want[0].tolist()
    assert sc.count_batch(texts).tolist() == want.tolist()
    assert want[0].sum() >= len(pats)  # each cut matches where it was cut
