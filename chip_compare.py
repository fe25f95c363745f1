#!/usr/bin/env python3
"""Time hand-written kernels of one checkout of ``apm_torch`` on one GPU.

Run from the root of a checkout::

    python3 chip_compare.py TREE LABEL

``TREE`` is the root of the checkout whose ``apm_torch`` is imported (and
whose kernels are built); the inputs, the timers and the plain versions'
gates are this script's own ``chip_smoke.py``, so two trees see the same
bytes. It runs every entry of ``CASES``: a function that yields
``(what, kernel, fn, plain, reps)``, where ``fn`` calls the
kernel's wrapper, ``kernel`` is a substring of the CUDA kernel's name, and
``plain`` (or None) its plain version, which ``fn`` must equal before it is
timed. Each prints one line ``AB LABEL ...``: the median of ``reps`` calls
between CUDA events (the wrapper's host work included) and the kernel's
device time from ``torch.profiler`` (mean of 5 calls, the kernel alone).
A case may only call what both trees to be compared have.

``--e2e`` times whole calls instead (``E2E``): ``Scanner.count`` of
``chip_smoke.py`` phase 5b's 256 MB k = 3 and k = 8 cells, on a writable
array and on a frozen copy of the same bytes, and ``Scanner.count_batch``
of phase 7's 64 corpora at k = 0, 1 and 3 (``--cases e2e_batch`` runs
one of the two). Each prints ``E2E LABEL ...``: the first call, the
median, least and most of ``--reps`` (3) more on the host clock (every
result equal to the first), the Scanner's own spans of one traced call,
and for ``count`` the device's busy share of one call
(``torch.profiler``).

To compare two commits on one card, unpack the parent into a directory
that ``.gitignore`` lists (``git archive``) and run parent, change, change,
parent in one call.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import os
import sys

import numpy as np


def device_ms(fn, kernel: str, reps: int = 5):
    """Mean device time of the launches of ``kernel`` (a substring of its
    name) in one call of ``fn``, from ``torch.profiler``'s CUDA activity:
    the kernel alone, without the wrapper's host work and the launch gaps
    that CUDA events around the call include. None when the profiler sees
    no such launch. (Not in chip_smoke.py: a profiler session there left
    its later device-busy readings short of kernel and copy events.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return sum(us) / reps / 1e3 if us else None


def filter_cases(cs, dev):
    """Kernel D: k = 3 on the pair 32 + 50 and k = 8 on 2 x 120, at 4096
    rows (held to the plain version) and on the 32768 rows of a 256 MB
    chunk, 7 calls each."""
    import torch
    from apm_torch.ops import filter_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    wf, main_rows = 8192, 32768
    corpus = random_corpus(main_rows * wf + 4096, seed=90)
    sets = {
        "pair": ([random_pattern(32, seed=93), random_pattern(50, seed=94)], 3, 2),
        "2x120": ([random_pattern(120, seed=95 + i) for i in range(2)], 8, 6),
    }
    for si, (pats, _, pk) in enumerate(sets.values()):
        for i, p in enumerate(pats):
            plant(corpus, p, range(753 + 211 * i + 53 * si, len(corpus) - 300, 100_003),
                  k=pk, seed=100 + i)
    for name, (pats, k, _) in sets.items():
        _, raw, plens, m_max = cs._pattern_table([p.tobytes() for p in pats], k)
        halo = round_up(m_max + 2 * k, 128)
        rows = cs.staged(corpus, 0, main_rows, wf, halo, dev)
        draw = torch.from_numpy(raw).to(dev)
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
        for n in (4096, main_rows):
            args = (rows[:n], draw, n * wf - 200, 0)
            plain = (lambda a=args, kw=kw: filter_kernel.scan_filter_ref(*a, **kw)) if n == 4096 else None
            yield (f"D k={k} {name} R={n}", "filter_pieces_kernel",
                   lambda a=args, kw=kw: filter_kernel.scan_filter(*a, **kw), plain, 7)


def filter_cell_cases(cs, dev):
    """Kernel D at the benchmark cells' shapes, 256 MiB of random text each:
    ``capture120`` (64 probes of 120 bytes at k = 12, seven banded pieces
    each, rows of 128 windows and a 256-byte halo) and ``repeat_k3`` (a
    32-byte and five 50-byte patterns at k = 3, rows of 4096 windows); each
    held to the plain version on its first 2048 rows, then timed whole."""
    import torch
    from apm_torch.ops import filter_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    cells = {
        "capture120": ([random_pattern(120, seed=300 + i) for i in range(64)], 12, 128),
        "repeat_k3": ([random_pattern(32, seed=370)] + [random_pattern(50, seed=371 + i)
                                                         for i in range(5)], 3, 4096),
    }
    for name, (pats, k, wf) in cells.items():
        n_rows = (256 << 20) // wf
        corpus = random_corpus(n_rows * wf + 4096, seed=380 + k)
        for i, p in enumerate(pats):
            plant(corpus, p, range(300 + 997 * i, len(corpus) - 400, 1_000_003), k=3, seed=390 + i)
        _, raw, plens, m_max = cs._pattern_table([p.tobytes() for p in pats], k)
        halo = round_up(m_max + 2 * k, 128)
        rows = cs.staged(corpus, 0, n_rows, wf, halo, dev)
        del corpus
        draw = torch.from_numpy(raw).to(dev)
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
        for n in (2048, n_rows):
            args = (rows[:n], draw, n * wf - 107, 0)
            plain = (lambda a=args, kw=kw: filter_kernel.scan_filter_ref(*a, **kw)) if n == 2048 else None
            yield (f"D {name} k={k} wf={wf} R={n}", "filter_pieces_kernel",
                   lambda a=args, kw=kw: filter_kernel.scan_filter(*a, **kw), plain, 3 if k == 12 else 7)


def corr_batch_cases(cs, dev):
    """Kernel #8: the first 1024-row group of ``count_batch``'s staging of
    40 corpora at P = 2 and P = 64, held to the plain version, 15 calls
    each."""
    import numpy as np
    import torch
    from apm_torch.ops import corr_fused
    from apm_torch.ops.corr_engine import build_alphabet
    from apm_torch.utils.corpus import random_pattern

    wf = 8192
    pair = [random_pattern(32, seed=321).tobytes(), random_pattern(50, seed=322).tobytes()]
    wide = [random_pattern(50, seed=330 + i).tobytes() for i in range(64)]
    plants = [(p, 200_003 + 1009 * i, 0) for i, p in enumerate(pair + wide[:6])]
    corpora = cs.mixed_corpora(40, 64 << 10, 4 << 20, 325, plants, alphabet=b"ACGT")
    for pats, name in ((pair, "P=2"), (wide, "P=64")):
        m_max = max(len(p) for p in pats)
        pat_raw = np.zeros((len(pats), m_max), np.uint8)
        for i, p in enumerate(pats):
            pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
        alph = build_alphabet(pats)
        km, thr = corr_fused.build_fused_tables(pat_raw, [len(p) for p in pats], alph)
        tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, corr_fused.pick_s(m_max), dev)
        rows, _, limits = cs.batch_groups(corpora, 8 * wf, wf, 128, lambda n: n - m_max + 1)[0]
        args = (torch.from_numpy(rows).to(dev), tabs, torch.from_numpy(limits).to(dev))
        kw = dict(wf=wf, halo=128, p_out=max(8, len(pats)))
        yield (f"#8 {name} R={rows.shape[0]}", "corr_batch_kernel",
               lambda a=args, kw=kw: corr_fused.scan_corr_batch_fused(*a, **kw),
               lambda a=args, kw=kw: corr_fused.scan_corr_batch_fused_ref(*a, **kw), 15)


def dp_cases(cs, dev):
    """Kernels A, C, #4 and #9: the shapes their records in
    ``chip_smoke.py`` time (A: the pair 32 + 50 at k = 1, C: six 50-mers
    at k = 12, both on 4096 rows; C at the density rescan's shape, the
    pair at k = 3 on the 32768 rows of a 256 MB chunk; #4: the first
    1024-row group of the 40-corpus staging at k = 1, band, and at k = 3
    and 12, Myers; #9: k = 1, P = 8 with device lengths), held to the
    plain versions, 5 calls each (3 at 256 MB)."""
    import torch
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import random_corpus, random_pattern

    wf, n_rows = 8192, 4096
    corpus = random_corpus(n_rows * wf + 4096, seed=3)
    pair = [random_pattern(32, seed=1).tobytes(), random_pattern(50, seed=2).tobytes()]
    six = [random_pattern(50, seed=80 + i).tobytes() for i in range(6)]
    for pats, k, impl, name in ((pair, 1, "band", "A k=1 P=2"), (six, 12, "myers", "C k=12 P=6")):
        pat, _, plens, m_max = cs._pattern_table(pats, k)
        halo = round_up(m_max + 2 * k, 128)
        rows = cs.staged(corpus, 0, n_rows, wf, halo, dev)
        alph = tuple(sorted(set(b"".join(pats))))
        peq = torch.from_numpy(dp_kernel.build_peq(pat, k, m_max, alph)).to(dev)
        args = (rows, torch.from_numpy(pat).to(dev), n_rows * wf - m_max + 1, 0)
        base = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
        kw = dict(base, alphabet=alph, peq=peq, dp_impl=impl)
        if impl == "myers":
            plain = functools.partial(dp_kernel.scan_folded_myers_ref, alphabet=alph, peq=peq, **base)
        else:
            plain = functools.partial(dp_kernel.scan_folded_dp_ref, **base)
        yield (f"{name} R={n_rows}", f"dp_{impl}_kernel",
               lambda a=args, kw=kw: dp_kernel.scan_folded_dp(*a, **kw),
               lambda a=args, f=plain: f(*a), 5)
    # the rescan's shape: a whole 256 MB chunk, the reference-shaped set's
    # two distinct patterns at k = 3 (Myers, both windows in one word)
    main_rows = 32768
    big = random_corpus(main_rows * wf + 4096, seed=70)
    pat, _, plens, m_max = cs._pattern_table(pair, 3)
    halo = round_up(m_max + 6, 128)
    alph = tuple(sorted(set(b"".join(pair))))
    peq = torch.from_numpy(dp_kernel.build_peq(pat, 3, m_max, alph)).to(dev)
    args = (cs.staged(big, 0, main_rows, wf, halo, dev), torch.from_numpy(pat).to(dev),
            main_rows * wf - m_max + 1, 0)
    base = dict(k=3, m_max=m_max, wf=wf, halo=halo, plens=plens)
    yield (f"C k=3 P=2 R={main_rows} (the rescan)", "dp_myers_kernel",
           lambda a=args, kw=dict(base, alphabet=alph, peq=peq, dp_impl="myers"):
           dp_kernel.scan_folded_dp(*a, **kw),
           lambda a=args, kw=dict(base, alphabet=alph, peq=peq): dp_kernel.scan_folded_myers_ref(*a, **kw), 3)
    del big
    corpora = cs.mixed_corpora(40, 64 << 10, 4 << 20, 303, [(pair[1], 40_000, 1), (pair[0], 90_000, 0)])
    for k, impl in ((1, "band"), (3, "myers"), (12, "myers")):
        pat, _, plens, m_max = cs._pattern_table(pair, k)
        halo = round_up(m_max + 2 * k, 128)
        rows, meta, _ = cs.batch_groups(corpora, 8 * wf, wf, halo,
                                        lambda n: max(0, min(n - m_max + 1, n - k)))[0]
        args = (torch.from_numpy(rows).to(dev), torch.from_numpy(pat).to(dev), torch.from_numpy(meta).to(dev))
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=tuple(sorted(set(b"".join(pair)))))
        yield (f"#4 {impl} k={k} R={rows.shape[0]}", f"dp_{impl}_kernel",
               lambda a=args, kw=kw: dp_kernel.scan_folded_dp_batch(*a, **kw),
               lambda a=args, kw=kw: dp_kernel.scan_folded_dp_batch_ref(*a, **kw), 5)
    lens = [12, 30, 41, 64]
    rng = np.random.default_rng(371)
    pats = [bytes(corpus[q : q + m]) for q, m in zip(rng.integers(0, n_rows * wf // 2, 4), lens)]
    pat, _, plens, m_max = cs._pattern_table(pats, 1)
    halo = round_up(m_max + 2, 128)
    rows = cs.staged(corpus, 3, n_rows, wf, halo, dev)
    dplen = torch.tensor(plens, dtype=torch.int32, device=dev)
    start = torch.tensor(3 * wf, dtype=torch.int32, device=dev)
    bound = torch.tensor(3 * wf + (n_rows - 5) * wf + 4321, dtype=torch.int32, device=dev)
    args = (rows, torch.from_numpy(pat).to(dev), dplen, bound, start)
    kw = dict(k=1, m_max=m_max, wf=wf, halo=halo)
    yield (f"#9 k=1 P=8 R={n_rows}", "dp_band_kernel",
           lambda a=args, kw=kw: dp_kernel.scan_folded(*a, **kw),
           lambda a=args, kw=kw: dp_kernel.scan_folded_ref(*a, **kw), 5)


def mask_cases(cs, dev):
    """Kernel #6 (the mask kernels): band k = 1 and Myers k = 3 on the pair
    32 + 50 at find's 512 gathered rows (``FIND_BATCH``) with a mid-row
    bound, held to the plain version, 9 calls each; where the tree has
    the grid query (``apm_dp_mask_grid``), an empty launch of the band
    mask kernel's grid (the launch floor)."""
    import torch
    from apm_torch.ops import _build, dp_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    wf, n_rows = 8192, 512
    pair = [random_pattern(32, seed=311).tobytes(), random_pattern(50, seed=312).tobytes()]
    corpus = random_corpus(n_rows * wf + 4096, seed=313)
    plant(corpus, np.frombuffer(pair[1], np.uint8), range(900, len(corpus) - 100, 9_001), k=1, seed=314)
    alph = tuple(sorted(set(b"".join(pair))))
    bound = (n_rows - 5) * wf + 4321
    lib = _build.library()
    for k, name in ((1, "band"), (3, "myers")):
        pat, _, plens, m_max = cs._pattern_table(pair, k)
        halo = round_up(m_max + 2 * k, 128)
        rows = cs.staged(corpus, 0, n_rows, wf, halo, dev)
        args = (rows, torch.from_numpy(pat).to(dev), bound, 0)
        peq = torch.from_numpy(dp_kernel.build_peq(pat, k, m_max, alph)).to(dev)  # as the Scanner
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=alph, peq=peq)
        fn = lambda a=args, kw=kw: dp_kernel.scan_folded_dp_mask(*a, **kw)
        plain = lambda a=args, kw=kw: dp_kernel.scan_folded_dp_mask_ref(*a, **kw)
        yield (f"#6 {name} k={k} R={n_rows}", name, fn, plain, 9)
        if k == 1 and hasattr(lib, "apm_dp_mask_grid"):
            stream = torch.cuda.current_stream(dev).cuda_stream
            grid = lib.apm_dp_mask_grid(n_rows, wf, min(k, m_max))
            _build.check(0 if grid > 0 else -grid, "apm_dp_mask_grid")
            empty = lambda g=grid: _build.check(lib.apm_empty_launch(g, 256, stream), "apm_empty_launch")
            yield (f"#6 empty launch of the band mask grid ({grid} blocks) R={n_rows}", "empty_kernel",
                   empty, None, 20)


# A later kernel's comparison is one more entry.
CASES = (filter_cases, corr_batch_cases, dp_cases, mask_cases, filter_cell_cases)


E2E_BYTES = 256 << 20  # phase 5b's cell size
E2E_CORPORA = (64, 1 << 19, 8 << 20)  # phase 7's corpora: count, smallest, largest


def e2e_count(cs, dev):
    """Phase 5b's 256 MB k = 3 (reference-shaped set) and k = 8 (2 x 120)
    cells, planted as there; each on the writable corpus, then on a frozen
    copy."""
    import apm_torch
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    size = E2E_BYTES
    base = random_corpus(size, seed=0)
    p32, p50 = random_pattern(32, seed=11), random_pattern(50, seed=12)
    long2 = [random_pattern(120, seed=210 + i) for i in range(2)]
    cells = (("k3_planted", [p32] + [p50] * 5, 3, [p50]), ("k8_banded_tier", long2, 8, long2))
    for name, pats, k, planted in cells:
        c = base.copy()
        for i, p in enumerate(planted):
            plant(c, p, range(5000 + i * 131072, size - 4096, 1 << 20), k=k, seed=13 + i)
        sc = apm_torch.Scanner([p.tobytes() for p in pats], k, apm_torch.ApmConfig(device=str(dev)))
        frozen = c.copy()
        frozen.setflags(write=False)
        mb = size >> 20
        yield f"{mb} MB {name} count, writable", sc, lambda sc=sc, c=c: sc.count(c), c
        yield f"{mb} MB {name} count, frozen", sc, lambda sc=sc, f=frozen: sc.count(f), frozen


def e2e_batch(cs, dev):
    """Phase 7's 64 corpora of 0.5 to 8 MB, k = 0, 1 and 3."""
    import apm_torch
    from apm_torch.utils.corpus import random_pattern

    p32, p50 = random_pattern(32, seed=341).tobytes(), random_pattern(50, seed=342).tobytes()
    pats = [p32] + [p50] * 5
    n, lo, hi = E2E_CORPORA
    corpora = cs.mixed_corpora(n, lo, hi, 343, [(p50, 1 << 18, 1), (p32, 1 << 19, 0)])
    for k in (0, 1, 3):
        sc = apm_torch.Scanner(pats, k, apm_torch.ApmConfig(device=str(dev)))
        yield f"count_batch {n} corpora k={k}", sc, lambda sc=sc: sc.count_batch(corpora), None


E2E = (e2e_count, e2e_batch)


def run_e2e(cs, dev, label, only=(), reps=3) -> int:
    import statistics
    import time

    import torch

    for cases in E2E:
        if only and cases.__name__ not in only:
            continue
        for what, sc, fn, corpus in cases(cs, dev):
            t0 = time.perf_counter()
            first = fn()
            first_ms = (time.perf_counter() - t0) * 1e3
            secs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                got = fn()
                secs.append((time.perf_counter() - t0) * 1e3)
                if got.tolist() != first.tolist():
                    print(f"{what}: a repeat's counts differ")
                    return 1
            sc.meter.trace = True
            try:
                fn()
                spans = dict(sc.meter.last_spans)
            finally:
                sc.meter.trace = False
            torch.cuda.synchronize()
            busy = f"; {cs.device_busy(sc, corpus)}" if corpus is not None else ""
            print(f"E2E {label} {what}: first {first_ms:.1f} ms, median {statistics.median(secs):.1f}"
                  f" ms of {reps} (min {min(secs):.1f}, max {max(secs):.1f}); spans "
                  + ", ".join(f"{n} {v:.3f}" for n, v in spans.items()) + busy, flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--cases", default="", help="comma-separated CASES (or E2E) names (default: all)")
    ap.add_argument("--e2e", action="store_true", help="time whole calls (E2E), not kernels")
    ap.add_argument("--reps", type=int, default=3, help="timed repeats of each E2E call")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible to torch; chip_compare needs one GPU")
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import apm_torch

    if not apm_torch.__file__.startswith(tree):
        print(f"imported {apm_torch.__file__}, not the tree {tree}")
        return 1
    dev = torch.device("cuda", 0)
    only = {c for c in args.cases.split(",") if c}
    if args.e2e:
        return run_e2e(cs, dev, args.label, only, args.reps)
    for cases in CASES:
        if only and cases.__name__ not in only:
            continue
        for what, kernel, fn, plain, reps in cases(cs, dev):
            if plain is not None:
                got, ref = fn(), plain()
                got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    print(f"{what}: kernel != plain")
                    return 1
            ms = cs.cuda_ms(fn, reps)
            d = device_ms(fn, kernel)
            print(f"AB {args.label} {what}: {ms:.4f} ms, device "
                  f"{'%.4f ms' % d if d is not None else 'not measured'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
