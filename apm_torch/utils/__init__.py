"""Utility layer: I/O, golden oracles, config, profiling, corpus tooling."""

from . import corpus, oracle, profiling
from .config import ApmConfig
from .io import PatternSet, read_input_file
from .oracle import (
    as_u8,
    banded_distances,
    count_matches,
    count_matches_reference,
    levenshtein_square,
)

__all__ = [
    "corpus",
    "oracle",
    "profiling",
    "ApmConfig",
    "PatternSet",
    "read_input_file",
    "as_u8",
    "banded_distances",
    "count_matches",
    "count_matches_reference",
    "levenshtein_square",
]
