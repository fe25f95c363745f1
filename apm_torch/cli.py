"""Command-line interface mirroring the reference binaries' usage and
output (port of ``apm/cli.py``; its output is byte-identical apart from the
time line).

Usage::

    python -m apm_torch <approx_factor> <dna_database> <pattern1> [pattern2 ...]
                        [PATTERNS_OVER_RANKS | DB_OVER_RANKS] [--flag ...]

Output (``sequential.c:79-82``, ``:151``, ``:157-160``):

* banner (typo "Mathing" included, for diff parity);
* ``APM done in %lf s``;
* ``Number of matches for pattern <%s>: %d`` — the pattern echoed verbatim,
  or cut to 100 chars when a trailing strategy word selects the reference's
  parallel variant (``%.100s``, ``patterns_over_ranks.c:229``), overridable
  with ``--[no-]truncate-echo``.

A trailing strategy word sets ``ApmConfig.strategy`` as ``apm``'s does
(``DB_OVER_RANKS`` -> ``database_over_devices``, ``PATTERNS_OVER_RANKS`` ->
``patterns_over_devices``) and selects the echo rule; ``--devices`` caps
the cards (on the CPU: the number of logical devices). Flags: ``--device``
(default ``cuda``), ``--backend`` (``auto``/``cuda``/``torch``),
``--block-windows``, ``--engine``, ``--devices``, ``--verbose``, and
``--positions`` (after the counts, one ``Match positions for pattern
<%s>: j ...`` line per pattern, from ``Scanner.find``).
"""

from __future__ import annotations

import sys
from typing import List, Optional

_STRATEGY_WORDS = {
    "DB_OVER_RANKS": "database_over_devices",
    "PATTERNS_OVER_RANKS": "patterns_over_devices",
    "DATABASE_OVER_DEVICES": "database_over_devices",
    "PATTERNS_OVER_DEVICES": "patterns_over_devices",
    "SINGLE": "single",
}

# flag -> (ApmConfig field, converter)
_VALUE_FLAGS = {
    "--backend": ("backend", str),
    "--device": ("device", str),
    "--devices": ("max_devices", int),
    "--block-windows": ("block_windows", int),
    "--engine": ("engine", str),
}


def _usage(prog: str) -> str:
    return (
        f"Usage: {prog} approximation_factor "
        "dna_database pattern1 pattern2 ...\n"
    )


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    prog = "apm"

    if len(argv) < 3:
        sys.stdout.write(_usage(prog))
        return 1

    from .utils.config import ApmConfig

    cfg = ApmConfig()
    truncate_echo: Optional[bool] = None  # None = variant default
    positions = False
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        name, _, value = a.partition("=")
        if name in _VALUE_FLAGS and (value or i + 1 < len(argv)):
            field, conv = _VALUE_FLAGS[name]
            if not value:
                value = argv[i + 1]
                i += 1
            setattr(cfg, field, conv(value))
        elif a == "--verbose":
            cfg.verbose = True
        elif a == "--interpret":
            cfg.interpret = True  # config parity with apm; no effect here
        elif a == "--positions":
            positions = True
        elif a == "--truncate-echo":
            truncate_echo = True
        elif a == "--no-truncate-echo":
            truncate_echo = False
        else:
            rest.append(a)
        i += 1

    # trailing strategy word (main.c:66-85: only meaningful as the LAST arg,
    # and only when at least one pattern remains before it). It selects the
    # reference's parallel variant, whose echo is cut to 100 chars.
    if len(rest) >= 4 and rest[-1].upper() in _STRATEGY_WORDS:
        cfg.strategy = _STRATEGY_WORDS[rest[-1].upper()]
        rest = rest[:-1]
        if truncate_echo is None:
            truncate_echo = True

    if len(rest) < 3:
        sys.stdout.write(_usage(prog))
        return 1

    try:
        approx_factor = int(rest[0])
    except ValueError:
        sys.stderr.write("Error while parsing argument 1\n")
        return 1
    filename = rest[1]
    patterns = [p.encode("latin-1") for p in rest[2:]]
    for idx, p in enumerate(patterns):
        if len(p) == 0:
            # sequential.c:65-68: zero-length pattern is a parse error
            sys.stderr.write(f"Error while parsing argument {idx + 3}\n")
            return 1

    sys.stdout.write(
        "Approximate Pattern Mathing: "
        f"looking for {len(patterns)} pattern(s) in file {filename} "
        f"w/ distance of {approx_factor}\n"
    )

    from .utils.io import read_input_file

    try:
        buf = read_input_file(filename)
    except OSError:
        sys.stderr.write(f"Unable to open the file {filename}\n")
        return 1

    from .models.scanner import Scanner

    scanner = Scanner(patterns, approx_factor, cfg)
    counts = scanner.count(buf)

    sys.stdout.write(f"APM done in {scanner.last_duration:.6f} s\n")
    for p, c in zip(patterns, counts):
        echo = p[:100] if truncate_echo else p
        sys.stdout.write(
            f"Number of matches for pattern <{echo.decode('latin-1')}>: {int(c)}\n"
        )
    if positions:
        # beyond the reference: exact window starts per pattern
        for p, pos in zip(patterns, scanner.find(buf)):
            echo = (p[:100] if truncate_echo else p).decode("latin-1")
            sys.stdout.write(
                f"Match positions for pattern <{echo}>:"
                + "".join(f" {int(j)}" for j in pos)
                + "\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
