"""One general generator: a configuration's data and a traffic mix's
requests, from the run's seed.

A configuration file names its corpus (``"corpus"``: bytes, line length
and planted repeats), optionally a fixed pattern ``"panel"`` and a batch of
``"contigs"`` of stated sizes cut from the corpus. A traffic file names the
call (``count`` or ``count_batch``), ``k`` and its patterns: the
configuration's panel, or ``{"cut": [...], "substitutions_max": s,
"fresh": bool}``, cuts of the corpus drawn anew for each request
(``fresh``) or once for the run.
Request ``i`` depends on the seed and ``i`` alone, so the check after the
window draws it again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from . import corpus as gen

WARM = 1_000_000_000  # request indices at and past this are warm-up's


@dataclass
class Request:
    key: int  # requests of one key ask the same question
    patterns: List[bytes]
    corpora: List[np.ndarray]

    @property
    def nbytes(self) -> int:
        return sum(len(c) for c in self.corpora)


class Workload:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        spec = config["corpus"]
        self.line = int(spec["line_bases"])
        text = gen.dna_lines(int(spec["bytes"]), self.line, self.seed, device)
        plant = spec.get("plant")
        if plant:
            text = gen.plant_lines(text, self.line, plant["lines"], int(plant["every_bytes"]),
                                   int(plant["max_substitutions"]), self.seed)
        self.text = text
        self.panel = gen.panel(text, self.line, config["panel"]) if "panel" in config else None
        batch = config.get("contigs")
        self.sizes = [int(n) for n in batch["sizes"]] if batch else None
        self.k = int(traffic["k"])

    def request(self, i: int) -> Request:
        pats = self.traffic["patterns"]
        if pats == "panel":
            patterns, key = self.panel, i
        else:
            key = i if pats.get("fresh", True) else 0
            rng = gen.stream(self.seed, 1, key)
            patterns = gen.cut_patterns(self.text, self.line, pats["cut"],
                                        int(pats.get("substitutions_max", 0)), rng)
        if self.sizes is not None:
            corpora = gen.contigs(self.text, self.sizes, gen.stream(self.seed, 2, i))
            key = i
        else:
            corpora = [self.text]
        return Request(key, patterns, corpora)
