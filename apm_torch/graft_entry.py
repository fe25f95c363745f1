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

:func:`dryrun_multichip` is the twin of ``__graft_entry__.py``'s: the
sharded scans on small shapes, each case against the oracle.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


def dryrun_multichip(devices: Optional[Sequence] = None) -> None:
    """Run the sharded scans once over ``devices`` (default: every visible
    card, or 8 logical CPU devices without one; a device may repeat) on
    ``apm``'s dry-run shapes, each case against the oracle: both strategies
    at k = 1; filtration phase 1 through kernel D (``engine="filter"``) and
    as a correlation (``fp1_conv``) under database sharding; k = 0 under
    ``corr_impl`` "fused" and "conv"; and the 32-phase fused tables (m in
    (66, 97]). Raises ``AssertionError`` on the first disagreement."""
    from .models.pipeline import make_plan
    from .models.scanner import Scanner
    from .parallel.strategies import count_distributed
    from .utils.config import ApmConfig
    from .utils.oracle import count_matches

    if devices is None:
        if torch.cuda.is_available():
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cpu")] * 8
    devices = [torch.device(d) for d in devices]
    assert len(devices) > 1, f"a dry run needs more than one device, got {devices}"

    rng = np.random.default_rng(42)
    alpha = np.frombuffer(b"ACGT\n", dtype=np.uint8)
    corpus = alpha[rng.integers(0, 5, size=4096)]
    pats = [alpha[rng.integers(0, 5, size=m)] for m in [5, 12, 33, 50, 8, 21, 17, 40]]

    def check(name, pats, k, strategy="database_over_devices", **kw):
        cfg = ApmConfig(device=str(devices[0]), block_windows=1024, **kw)
        sc = Scanner(pats, k, cfg)
        got = count_distributed(sc, corpus, strategy, devices)
        got = got[: sc.scan_patterns.num_patterns][sc._inverse].tolist()
        want = count_matches(corpus, pats, k)
        assert got == want, (name, got, want)
        return sc

    for strategy in ("database_over_devices", "patterns_over_devices"):
        check(strategy, pats, 1, strategy)
    check("filter_sharded", pats, 1, engine="filter")
    pats_fp1 = [alpha[rng.integers(0, 5, size=m)] for m in (50, 64)]
    sc = check("fp1_conv_sharded", pats_fp1, 1)
    assert make_plan(sc, len(corpus)).fp1_conv, "fp1_conv_sharded: no conv phase 1"
    for corr_impl in ("fused", "conv"):
        sc = check(f"corr_sharded[{corr_impl}]", pats, 0, engine="corr", corr_impl=corr_impl)
        assert sc._routes(make_plan(sc, len(corpus)))[0] == corr_impl, corr_impl
    pats_s32 = [bytes(corpus[100:180]), bytes(corpus[2000:2097])]
    check("corr_sharded_s32", pats_s32, 0, engine="corr", corr_impl="fused")
