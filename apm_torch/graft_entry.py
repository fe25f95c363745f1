"""The port's counterpart of the repo's ``__graft_entry__.py`` ``entry()``.

:func:`entry` returns ``(fn, example_args)``: one forward step of the
flagship scan, a whole-corpus banded-Levenshtein count per pattern, over
the same example (a seed-0 8192-byte ``ACGT\\n`` corpus, the patterns
GATTACA and ACGTACGTACGT, k = 1, blocks of 1024 windows, tables padded to
8 rows). ``fn(*example_args)`` returns ``(8,)`` int32 counts.

- On a CUDA device (the default) it stages the corpus with
  :func:`apm_torch.ops.common.fold_corpus` and runs the dynamic-length band
  (:func:`apm_torch.ops.dp_kernel.scan_folded`, TPU kernel #9's port) over
  the device-owned windows ``j < min(n - m_max + 1, n - k)``, as ``apm``'s
  TPU branch does.
- With ``device="cpu"`` it runs the reference engine
  (:func:`apm_torch.ops.torch_engine.scan_corpus_torch`) over every window,
  EOF-truncated ones included, as ``apm``'s non-TPU branch does.

The two branches count different window sets, as ``apm``'s two do.
Distribution (``dryrun_multichip``) is not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import numpy as np
import torch

K, W = 1, 1024
PATTERNS = (b"GATTACA", b"ACGTACGTACGT")


def example_corpus() -> np.ndarray:
    """The example's corpus: 8192 seeded bytes of ``ACGT\\n``."""
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT\n", dtype=np.uint8)
    return alpha[rng.integers(0, 5, size=8192)]


def example_tables():
    """``(pat (8, m_max + 2k) uint8, plen (8,) int32, m_max)``: the
    example's k-padded pattern table, padded to 8 rows."""
    from .utils.io import PatternSet

    ps = PatternSet.from_patterns(list(PATTERNS))
    pat, plen = ps.packed(K)
    pat8 = np.zeros((8, pat.shape[1]), np.uint8)
    pat8[: pat.shape[0]] = pat
    plen8 = np.zeros((8,), np.int32)
    plen8[: plen.shape[0]] = plen
    return pat8, plen8, ps.max_len


def entry(device: str = "cuda"):
    """``(fn, example_args)`` of the flagship scan on ``device`` (module
    doc): the dynamic-length band on a CUDA device, the reference engine
    on the CPU."""
    from .ops.common import fold_corpus, pad_corpus, round_up

    dev = torch.device(device)
    corpus = example_corpus()
    pat8, plen8, m_max = example_tables()
    n = len(corpus)
    tables = (torch.from_numpy(pat8).to(dev), torch.from_numpy(plen8).to(dev))

    if dev.type == "cuda":
        from .ops.dp_kernel import FOLD, scan_folded

        wf = W // FOLD
        halo = round_up(m_max, 128)
        bound = max(0, min(n - m_max + 1, n - K))
        n_rows = max(FOLD, round_up(-(-bound // wf), FOLD))
        rows = fold_corpus(corpus, 0, n_rows, wf, halo)

        def fn(rows_arr, pat_arr, plen_arr, bound_arr, start_arr):
            return scan_folded(
                rows_arr, pat_arr, plen_arr, bound_arr, start_arr,
                k=K, m_max=m_max, wf=wf, halo=halo,
            )

        return fn, (
            torch.from_numpy(rows).to(dev),
            *tables,
            torch.tensor(bound, dtype=torch.int32, device=dev),
            torch.tensor(0, dtype=torch.int32, device=dev),
        )
    if dev.type != "cpu":
        raise ValueError(f"entry() runs on a CUDA device or the CPU, got {device!r}")
    from .ops.torch_engine import scan_corpus_torch

    n_pad = max(round_up(max(n - K, 0), W), W)
    buf = pad_corpus(corpus, n_pad, m_max)

    def fn(corpus_arr, pat_arr, plen_arr, n_arr, start_arr):
        return scan_corpus_torch(
            corpus_arr, pat_arr, plen_arr, n_arr, start_arr, k=K, m_max=m_max, v=W,
        )

    return fn, (
        torch.from_numpy(buf).to(dev),
        *tables,
        torch.tensor(n, dtype=torch.int32, device=dev),
        torch.tensor(0, dtype=torch.int32, device=dev),
    )
