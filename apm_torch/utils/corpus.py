"""Synthetic corpus generation — test/bench data tooling.

Copy of ``apm/utils/corpus.py`` (pure NumPy), so the port imports without
JAX.

The reference ships fixed FASTA-ish files (``dna/``, SURVEY.md §2 #17) and
points at UCSC downloads for larger runs. For benchmarks and adversarial
tests we also generate corpora: random DNA-like byte streams with exact or
fuzzy (<= k edits) pattern plants at controlled positions — including the
shard-boundary-straddling case the reference never tested.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

DNA_ALPHABET = b"ACGT\n"  # newline included: corpora are raw bytes


def random_corpus(
    n: int, seed: int = 0, alphabet: bytes = DNA_ALPHABET
) -> np.ndarray:
    """Uniform random byte corpus over ``alphabet``. (n,) uint8."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    return alpha[rng.integers(0, len(alpha), size=n)]


def random_pattern(
    m: int, seed: int = 0, alphabet: bytes = b"ACGT"
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    return alpha[rng.integers(0, len(alpha), size=m)]


def mutate(
    pattern: np.ndarray,
    k: int,
    seed: int = 0,
    alphabet: bytes = b"ACGT",
    substitutions_only: bool = False,
) -> np.ndarray:
    """Apply exactly ``k`` random edits (sub/ins/del) to a pattern copy."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    w = pattern.copy()
    for _ in range(k):
        op = 0 if substitutions_only else int(rng.integers(0, 3))
        i = int(rng.integers(0, max(1, len(w))))
        if op == 0:
            w[i] = alpha[rng.integers(0, len(alpha))]
        elif op == 1 and len(w) > 1:
            w = np.delete(w, i)
        else:
            w = np.insert(w, i, alpha[rng.integers(0, len(alpha))])
    return w


def plant(
    corpus: np.ndarray,
    pattern: np.ndarray,
    positions: Sequence[int],
    k: int = 0,
    seed: int = 0,
    substitutions_only: bool = True,
) -> np.ndarray:
    """Plant (possibly mutated) copies of ``pattern`` at ``positions``.

    Mutates ``corpus`` in place and returns it. With ``k > 0`` each plant
    carries exactly ``k`` random edits. NB: only substitution edits
    guarantee a window within distance ``k`` at the plant position under
    the equal-length window semantics — an indel shifts the planted tail,
    so the windowed distance can reach ``2k``. Pass
    ``substitutions_only=False`` for general fuzz material.
    """
    for idx, pos in enumerate(positions):
        w = (
            mutate(
                pattern, k, seed=seed + idx,
                substitutions_only=substitutions_only,
            )
            if k > 0
            else pattern
        )
        end = min(len(corpus), pos + len(w))
        corpus[pos:end] = w[: end - pos]
    return corpus


def boundary_straddling_corpus(
    n: int,
    pattern: np.ndarray,
    shard_width: int,
    k: int = 0,
    seed: int = 0,
    alphabet: bytes = DNA_ALPHABET,
) -> Tuple[np.ndarray, List[int]]:
    """Corpus with one plant straddling every ``shard_width`` boundary.

    The adversarial case for halo/ownership bugs (the reference
    double-counts these windows, Report §4.3). Returns (corpus, positions).
    """
    corpus = random_corpus(n, seed=seed, alphabet=alphabet)
    positions = []
    b = shard_width
    while b + len(pattern) < n:
        pos = b - len(pattern) // 2
        if pos >= 0:
            positions.append(pos)
        b += shard_width
    plant(corpus, pattern, positions, k=k, seed=seed)
    return corpus, positions
