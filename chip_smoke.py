#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apm_torch``) once on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. environment: card name and power limit (``nvidia-smi``), torch/CUDA
   versions, the build of every kernel from ``apm_torch/csrc`` and of the
   host library from ``apm_torch/csrc/host/apmio.cpp`` (``g++``); then the
   host layer on this machine's CPU: the native fold of a 256 MB chunk into
   page-locked rows beside the NumPy ``fold_corpus_ref`` (equal rows),
   ``hash_bytes`` of the chunk, and the EOF tails of the k = 3 and k = 8
   cells through the native verifier beside the NumPy oracle (equal
   counts);
2. kernel A (banded DP, ``csrc/dp_band.cu``) against its plain PyTorch
   version on the card at main-path shapes (8192-window rows, 128-byte
   halo, 4096 rows = 32 MB), k in {0, 1, 2, 3}, a mixed-length set with a
   mid-row bound, and a band wider than the register path (k = 17);
2b. kernel C (bit-parallel Myers band, ``csrc/dp_myers.cu``) against its
   plain version and against kernel A at 4096 rows, k in {3, 4, 8, 12, 14},
   P = 2 (m 32, 50) and P = 6 (m 50), a case with start > 0 and a mid-row
   bound held in device memory, and P = 6 at k = 12 on the 32768 rows of a
   256 MB chunk;
3. kernel B (fused k = 0 correlation, ``csrc/corr_fused.cu``) against its
   plain version (the TPU's bit-plane matmul formulation) at P = 2, P = 64
   (int8 tables) and m = 80 (32-phase tables), and at P = 2 and P = 64 on
   the 32768 rows of a 256 MB main-path chunk; its edge cases at small
   size: patterns of 1, 3 and 7 bytes and m = 97, all-A text against A^m
   patterns (every window hits), rows taken as a view at a row offset with
   start > 0 and a bound inside a thread's tile of windows;
3b. kernel D (pigeonhole piece filter, ``csrc/filter_pieces.cu``) against
   its plain version, candidate totals and row maps cell for cell: k = 0 on
   a short set, k = 1 and k = 3 exact tier, k = 8 and k = 16 banded tier,
   and k = 3 and k = 8 on the 32768 rows of a 256 MB chunk; its edge cases
   at 512 rows: k = 0 patterns of 3 and 7 bytes, 8- and 14-byte pieces
   (exact, and banded with 7-byte heads), and all-A text at k = 1 and 8;
4. end to end, k = 0, 256 MB (one chunk) and 512 MB (two chunks):
   ``Scanner.count`` on the reference-shaped pattern set (1 x 32 + 5 x 50
   bytes, seeded), gated by a host substring count plus the oracle on the
   EOF tail; MB/s three ways, each call gated by the same counts: cold (the
   device cache emptied first: hash, fold, copy), warm on a frozen array
   (a cache hit with a memoized key: its spans hold no fold and no copy)
   and warm on a writable array (the hash, then a hit);
5. end to end, k = 1 and k = 2, ``engine="dp"``, 32 MB with planted
   approximate copies: the kernels against the plain versions over the same
   plan on the card, and a 1 MB prefix against the NumPy oracle;
5b. end to end at k >= 1 under ``engine="auto"`` on bench.py's 256 MB
   cells (k = 1, 2, 3 planted on the reference-shaped set, k4_exact_tier,
   k8_banded_tier, k12_myers_dp) and a k = 0 short set, each gated by the
   same scan under ``engine="dp", dp_impl="band"`` and by a 1 MB prefix
   against the oracle; a dense cell that takes the density rescan and an
   overflow cell that takes ``count_hot_batch``; MB/s under ``auto`` cold,
   warm frozen and warm writable as in phase 4, and cold under
   ``engine="dp"``, then a phase breakdown of the k = 3 and k = 8 cells,
   cold and warm (the Scanner's own spans, and the device's busy share from
   ``torch.profiler``);
6. the CLI (``python -m apm_torch``) against lines built from the oracle;
2c. kernel #4 (the batch mode of kernels A and C) against its plain version
   on every 1024-row group of ``count_batch``'s staging of 40 mixed corpora
   (64 KB to 4 MB), k = 1 (band), 3 and 12 (Myers);
2d. kernel #6 (the mask kernels, ``csrc/dp_mask.cu``) against its plain
   version at 512 rows (``FIND_BATCH``), band k = 1 and Myers k = 3, a
   mid-row bound: counts and verdicts byte for byte, each timed against its
   bound; the bit pack and per-row top-k timed; edge cases at 40 rows
   (k = 16 and 17, m < k, NUL and foreign bytes, all-A text, an odd wf, a
   bound in device memory);
3c. kernel #8 (the batch mode of kernel B) against its plain version on the
   same kind of staging at P = 2, P = 64 (int8 tables) and m = 70, 80, and
   on 6 corpora patterns of 1, 3 and 7 bytes and all-A text against A^m;
   an empty launch of #8's grid timed beside its bound;
2e. kernel #9 (kernel A's dynamic-length entry, ``scan_folded``) against
   its plain version and against kernel A's count mode at 4096 rows: P = 8
   with padding rows and mixed lengths, k in {0, 1, 3}, start > 0 and a
   mid-row bound, lengths, start and bound in device memory, two length
   vectors through one tensor;
3d. kernel #7 (the fused piece scan, ``csrc/corr_pieces.cu``) against its
   plain version, fcnt and row map cell for cell, on the Scanner's piece
   tables of the reference-shaped set under ``corr_impl="fused"`` at
   k = 1, 2 and 4, at 4096 rows and on the 32768 rows of a 256 MB chunk,
   timed beside the piece conv that ``corr_impl="auto"`` runs; its edge
   cases at small size: 8- and 9-byte pieces and m = 65, all-A text (every
   position hits), and P = 64 (128 pieces, also timed at 4096 rows);
4b. (in phase 4, 256 MB) k = 0 through ``apm``'s correlation conv (plain
   PyTorch ``conv1d``): ``corr_impl="conv"`` on the reference-shaped set
   and ``auto`` at m_max = 120, gated like phase 4, MB/s beside kernel B
   and ``engine="dp"``;
5c. (in phase 5b) the 256 MB k = 1 and k = 2 cells under
   ``corr_impl="fused"`` (kernel #7 as filtration phase 1), gated by the
   same ``engine="dp", dp_impl="band"`` counts and 1 MB oracle prefix;
7. ``Scanner.count_batch`` on 64 corpora of 0.5 to 8 MB, k = 0, 1 and 3,
   gated by ``count`` on each corpus and the oracle; MB/s and corpora/s
   beside the loop of ``count``, and the split of one traced call (its own
   spans: fold, copy, launches, the native EOF tails, then the fetch, in
   that order); at k = 0 also
   ``corr_impl="conv"`` (the batched conv), gated by the kernel #8 route's
   counts;
8. ``Scanner.find``: 256 MB k = 1 sparse (kernel D, then #6) and two 4 MB
   dense cells of a 9-byte pattern at k = 2 (the mask sweep: the ``gpos``
   decode on random text, the packed-mask fallback on all-A text), gated by
   ``count``, a 1 MB oracle prefix and a 32 MB cut under the plain versions;
9. the CLI with ``--positions`` against lines built from the oracle;
10. ``apm_torch.graft_entry.entry()``: ``fn(*args)`` on the card (kernel
   #9), equal to its plain version and to the oracle over the device-owned
   windows;
11. the rest of the serving surface on phase 4's 256 MB k = 0 cell, each
   gated by its counts: ``count_file`` of a temporary file, ``count_stream``
   of the same bytes in 16 MB pieces, ``warmup(256 MB)`` timed and then the
   first ``count`` beside a first ``count`` without warmup, a Scanner with
   ``prewarm_bytes`` joined before its first call, and an eviction at a
   ``cache_bytes`` of one chunk (128 MB chunks);
12. distribution, every shard on card 0 (the times are the cost of
   sharding on one card, not scaling), each call gated by the counts
   phases 4 and 5b gated: (a) ``count_distributed(...,
   "database_over_devices", [cuda:0] * 2)`` and ``* 4`` on phase 4's
   256 MB k = 0 cell and phase 5b's k1 (``corr_impl="fused"``), k3, k8,
   dense and overflow cells, each with its ``last_filtration`` route and
   cold ms beside the single-device call; (b) ``patterns_over_devices`` x 2
   on the k = 3 cell; (c) ``Scanner.count`` under
   ``strategy="database_over_devices"`` on the visible cards (``n_dev``,
   ``last_strategy``); (d) ``count_multihost`` of the k = 0 and k = 3
   cells written to files, in a 1-process ``nccl`` world and in 2
   processes under ``gloo`` on card 0 (this script re-run as the worker,
   ``--multihost-worker``, with a timeout; a non-zero exit fails the
   phase); (e) ``graft_entry.dryrun_multichip([cuda:0] * 4)``;
13. ``apm_torch.utils.fuzz.run_fuzz`` on the card: 36 trials, seed 0,
   corpora of 64 to 512 KB, the oracle on the host's threads.

The main path is the first ``Scanner.count`` of each end-to-end path of
phases 4, 5 and 5b, the first ``count_batch`` or ``find`` of each path
of phases 7 and 8, the first ``fn(*args)`` of phase 10, each path of
phase 11 and the first sharded call of each case of phases 12a, 12b and
12d (the two workers' counts read in the workers): every kernel
launch counter is set to 0 just before it
and read just after, and each path must have launched the kernels its
route runs (gates, prefixes and timed repeats are not counted). The line
before the last is a JSON object with each kernel's main-path launches,
largest disagreement, its time beside its plain version's and its bound
(the larger of its bytes over the memory rate and its integer
instructions over the issue rate); the last line is the device record.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events, one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def host_exact_count(corpus: bytes, pat: bytes) -> int:
    """Overlapping occurrences of ``pat`` in ``corpus`` (bytes.find)."""
    n, i = 0, corpus.find(pat)
    while i != -1:
        n += 1
        i = corpus.find(pat, i + 1)
    return n


# The least time the card could take for a kernel's work (``bound_ms``) is
# the larger of its bytes over the H100's memory rate (3.35 TB/s) and its
# integer instructions over the card's issue rate: each of an SM's four
# schedulers issues one 32-lane instruction per clock, so 132 SMs x 128
# lanes x 1.98 GHz boost clock (the float32 row of the card's table, 67
# TFLOP/s, is the same issue rate at two flops per FMA). Integer work uses
# both the INT32 pipe and the FMA pipe (nvcc emits IMAD forms of adds and
# moves), so the INT32 pipe alone (64 lanes per SM) is not a ceiling. Both
# rates are the published peaks of the SXM part at 700 W.
HBM_BYTES_PER_S = 3.35e12
INT_ISSUE_PER_S = 132 * 128 * 1.98e9

# Instructions per unit of work, read from the kernels' SASS
# (`cuobjdump -sass` of the sm_90a build, printed by phase 1 through
# sass_loops; loads, address arithmetic and loop overhead included): kernel A's k = 1 step loop (dp_band.cu, KE = 1)
# issues 80 instructions per 4 unrolled steps of 3 band cells; kernel C's
# static and moving loops (dp_myers.cu) 103 and 125 per 4 unrolled steps.
# The work of an exact scan is counted the same whatever implements it:
# the early-exit byte compares it needs (bytes compared up to the first
# mismatch), 3 each (load, compare, branch). Kernels B, #8 and #7 compare
# each pattern or piece at every position they own; kernel D compares each
# piece's head bytes (its first min(li, 8) bytes, or min(8, li // 2) in the
# banded tier) at every text position an owned window reaches (lanes
# [0, limit + span) from o + s_lo), which any exact or banded piece test
# must do at least. Steps of one design (a shift OR per window and shift,
# the band on the survivors) are not counted: a bound
# that counted them would credit a kernel that skips them with work it
# does not do.
BAND_K1_STEP_INSTR = 20
MYERS_STATIC_STEP_INSTR = 103 / 4
MYERS_MOVING_STEP_INSTR = 125 / 4
COMPARE_OPS = 3
# Kernel #6 (the mask kernels) is counted from its work, at the fewest
# instructions the card needs, not from one design's SASS. A band cell is a
# compare and three min-plus terms: four instructions for the two windows
# of a paired 16-bit word on Hopper's DPX forms (XOR, VIADDMNMX, VIMNMX3,
# VIADDMNMX), so 2 a window. A Myers step is Hyyro's bit-vector update with
# each logic term of up to three inputs one LOP3: eq & vp, the add, xh and
# xv (4), ph (2), mh (1), ph's and mh's shifts with their masks (4), the
# centre bit and the count (3), vp (2) and vn (1), 17 in all, plus the
# match word's load; the moving band re-indexes VP and VN first (3 more).
# Where the band fits a 16-bit field (2k + 1 <= 15) one update advances two
# windows packed in one word, for two match-word loads and one instruction
# that joins the two words: 20 a pair (23 moving), 10 and 11.5 a window.
MASK_BAND_CELL_INSTR = 2
MASK_MYERS_STATIC_STEP_INSTR = 18
MASK_MYERS_MOVING_STEP_INSTR = 21
MASK_MYERS_PAIR_STATIC_STEP_INSTR = 20
MASK_MYERS_PAIR_MOVING_STEP_INSTR = 23


def band_k1_instr(owned: int, plens) -> int:
    """Instructions of kernel A at k = 1 over ``owned`` windows."""
    return owned * sum(plens) * BAND_K1_STEP_INSTR


def myers_instr(owned: int, plens, k: int) -> int:
    """Instructions of kernel C over ``owned`` windows: min(k, m) static
    steps and m - k moving steps per pattern."""
    per_window = sum(min(k, m) * MYERS_STATIC_STEP_INSTR + max(m - k, 0) * MYERS_MOVING_STEP_INSTR
                     for m in plens if m)
    return int(owned * per_window)


def mask_band_instr(owned: int, plens, k: int) -> int:
    """Least instructions of kernel #6's band mode over ``owned`` windows:
    m_p steps of 2k + 1 cells per pattern (k = ke: m_max > k here)."""
    return owned * sum(plens) * (2 * k + 1) * MASK_BAND_CELL_INSTR


def mask_myers_instr(owned: int, plens, k: int) -> int:
    """Least instructions of kernel #6's Myers mode over ``owned`` windows:
    a window pair per update where 2k + 1 <= 15, else one window."""
    if 2 * k + 1 <= 15:
        per_pair = sum(min(k, m) * MASK_MYERS_PAIR_STATIC_STEP_INSTR
                       + max(m - k, 0) * MASK_MYERS_PAIR_MOVING_STEP_INSTR for m in plens if m)
        return owned * per_pair // 2
    return owned * sum(min(k, m) * MASK_MYERS_STATIC_STEP_INSTR
                       + max(m - k, 0) * MASK_MYERS_MOVING_STEP_INSTR for m in plens if m)


def sass_loops(lib_path: str, kernel: str, nested: bool = False, ops: bool = False) -> str:
    """Instruction counts of the innermost loops of ``kernel`` in the built
    library's SASS (``cuobjdump -sass``), the source of the per-step counts
    above: ``start-end: N instructions, L global and S shared loads`` for
    each backward branch that encloses no other. ``nested``: every loop
    instead, each counted without the loops inside it. ``ops``: each loop's
    opcodes too, with their counts."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "not measured (no cuobjdump)"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=120).stdout
    sec = next((x for x in sass.split("Function : ")[1:] if kernel in x.split("\n", 1)[0]), "")
    ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sec)]
    loops = []
    for i, (a, op) in enumerate(ins):
        m = re.search(r"BRA\s+.*?0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a, i))
    inside = lambda l, o: o != l and l[0] <= o[0] and o[1] <= l[1]  # o in l
    inner = [l for l in loops if nested or not any(inside(l, o) for o in loops)]
    out = []
    for t, a, i in inner:
        holes = [o for o in loops if inside((t, a, i), o)]
        body = [op for b, op in ins[: i + 1]
                if b >= t and not any(o[0] <= b <= o[1] for o in holes)]
        line = (f"{t:#x}-{a:#x}: {len(body)} instructions, "
                f"{sum('LDG' in op for op in body)} global and {sum('LDS' in op for op in body)} shared loads")
        if ops:
            names = [re.sub(r"^@!?U?P\w+\s+", "", op).split()[0] for op in body]
            line += " (" + " ".join(f"{n} {names.count(n)}" for n in sorted(set(names))) + ")"
        out.append(line)
    return "; ".join(out) or "no loop found"


def ptxas_of(log: str, kernel: str) -> str:
    """Registers, spills and shared memory of ``kernel`` in the ``nvcc
    -Xptxas -v`` output of the build."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("spill" in line or "registers" in line):
            out.append(line.split(":", 1)[-1].strip() if "registers" in line else line.strip())
    return "; ".join(out) or "not found"


def bound_of(n_bytes: float, ops: float):
    """``(bound_ms, bound_by)`` of work that moves ``n_bytes`` and issues
    ``ops`` integer instructions."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / INT_ISSUE_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def owned_lanes(n_rows, wf, bound, start=0):
    """(R,) owned lanes of staged rows under a window bound, on the host."""
    r = np.arange(n_rows, dtype=np.int64)
    return np.clip(bound - start - r * wf, 0, wf)


def compare_ops(rows, seqs, limits, wf, width=None) -> int:
    """Integer operations of early-exit byte compares over the owned
    windows of staged rows (the data decides where each exits): for each
    ``(bytes, offset)`` in ``seqs``, a window at lane ``l`` compares
    ``bytes`` with the text at ``l + offset`` until the first mismatch.
    ``limits[r]`` lanes of row ``r`` are scanned, of ``width`` (default
    ``wf``) positions per row."""
    import torch

    dev = rows.device
    width = width or wf
    lane = torch.arange(width, device=dev)
    own = lane[None, :] < torch.as_tensor(np.asarray(limits), device=dev)[:, None]
    total = 0
    for seq, off in seqs:
        alive = own.clone()
        for i, b in enumerate(seq):
            n = int(alive.sum())
            if n == 0:
                break
            total += n
            alive &= rows[:, off + i : off + i + width] == int(b)
    return total * COMPARE_OPS


def filter_ops(rows, raw, plens, k, limits, wf) -> int:
    """Integer operations of kernel D's work on these inputs (the rule
    above): each piece's head bytes compared, up to the first mismatch, at
    every position an owned window of its row reaches."""
    from apm_torch.ops.filter_kernel import piece_layout

    table, pstart = piece_layout(tuple(int(m) for m in plens), k)
    total = 0
    for p in range(len(plens)):
        for off, span, _li, _kp, o, _t, n_head, _n in table[pstart[p] : pstart[p + 1]].tolist():
            reach = np.where(limits > 0, limits + span, 0)
            total += compare_ops(rows, [(raw[p, o : o + n_head], off)], reach, wf, width=wf + span)
    return total


class KernelRecord:
    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.max_abs_err = 0
        self.ms = None
        self.plain_ms = None
        self.bound_ms = None
        self.bound_by = None

    def compare(self, got, ref, what):
        import torch

        need(got.shape == ref.shape, f"{self.name} {what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max().item())
        self.max_abs_err = max(self.max_abs_err, err)
        need(err == 0, f"{self.name} {what}: kernel != plain, {int((got != ref).sum())} cells differ")

    def measured(self, ms, plain_ms, n_bytes, ops, what, keep=True):
        """Print a case's bound and share; ``keep``: the case the record
        reports, with its times."""
        bound_ms, bound_by = bound_of(n_bytes, ops)
        if keep:
            self.ms, self.plain_ms, self.bound_ms, self.bound_by = ms, plain_ms, bound_ms, bound_by
        say(f"  {self.name} record ({what}{'' if keep else ', printed only'}): {n_bytes} bytes, "
            f"{ops} integer instructions, bound {bound_ms:.4f} ms by {bound_by}, kernel "
            f"{ms:.3f} ms (roofline share {100 * bound_ms / ms:.1f} %)")
        return bound_ms

    def json(self, launches):
        # No single PyTorch call computes a banded Levenshtein verdict, an
        # exact-window count or a piece-hit row map (a conv1d gives scores,
        # which still need a threshold and a per-row reduction): library_ms
        # stays null for every kernel here.
        return {
            "name": self.name, "route": "cuda", "source": self.source,
            "replaces": self.replaces, "launches": launches,
            "max_abs_err": self.max_abs_err, "ms": self.ms,
            "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
            "bound_by": self.bound_by, "library_ms": None,
        }


class MainPath:
    """Kernel launches of the main path. Before each counted run every
    counter is set to 0; after it the counts are read, the kernels the
    run's route must launch are checked, and the counts are added to the
    totals the ``kernels`` line reports. A route of plain PyTorch only (the
    k = 0 conv, which ``apm`` leaves to XLA) expects no launch."""

    def __init__(self):
        from apm_torch.ops import corr_fused, dp_kernel, filter_kernel

        self.counters = {
            "dp_band": (dp_kernel, "LAUNCHES"),
            "corr_fused": (corr_fused, "LAUNCHES"),
            "dp_myers": (dp_kernel, "MYERS_LAUNCHES"),
            "filter_pieces": (filter_kernel, "LAUNCHES"),
            "dp_batch": (dp_kernel, "BATCH_LAUNCHES"),
            "dp_mask": (dp_kernel, "MASK_LAUNCHES"),
            "corr_batch": (corr_fused, "BATCH_LAUNCHES"),
            "pieces_fused": (corr_fused, "PIECE_LAUNCHES"),
            "dp_dyn": (dp_kernel, "DYN_LAUNCHES"),
        }
        self.total = dict.fromkeys(self.counters, 0)

    def reset(self):
        for mod, attr in self.counters.values():
            setattr(mod, attr, 0)

    def read(self):
        return {name: getattr(mod, attr) for name, (mod, attr) in self.counters.items()}

    def record(self, what, expect, got):
        """Check and add the launches ``got`` of one counted run (read here,
        or in a worker process of phase 12)."""
        need(all(got[name] > 0 for name in expect),
             f"{what}: expected launches of {expect}, got {got}")
        for name, v in got.items():
            self.total[name] += v
        say(f"main path {what}: launches {got}")

    def run(self, what, expect, fn):
        self.reset()
        out = fn()
        self.record(what, expect, self.read())
        return out


def staged(corpus, start_row, n_rows, wf, halo, dev):
    import torch

    from apm_torch.ops.common import fold_corpus

    rows = fold_corpus(corpus, start_row * wf, n_rows, wf, halo)
    return torch.from_numpy(rows).to(dev)


def _pattern_table(pats, k):
    """k-padded table, raw table, static lengths and m_max of a pattern
    list, padded to a multiple of 8 slots (the Scanner's layout)."""
    from apm_torch.ops.common import round_up
    from apm_torch.utils.io import PatternSet

    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    p_pad = max(8, round_up(len(pats), 8))
    pat = np.zeros((p_pad, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    raw = np.zeros((p_pad, ps.max_len), np.uint8)
    raw[: len(pats)] = ps.table
    plens = tuple(len(p) for p in pats) + (0,) * (p_pad - len(pats))
    return pat, raw, plens, ps.max_len


def phase_dp(rec, dev, n_rows: int = 4096) -> None:
    """Kernel A against scan_folded_dp_ref at main-path shapes."""
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    import torch

    wf = 8192
    p32, p50 = random_pattern(32, seed=1), random_pattern(50, seed=2)
    corpus = random_corpus(n_rows * wf + 4096, seed=3)
    pos = list(range(1000, len(corpus) - 200, 65_537))
    plant(corpus, p50, pos, k=1, seed=4)
    plant(corpus, p32, [p + 90 for p in pos], k=0)

    def case(pats, k, n, start_row, bound, what, reps=5, plain_reps=2, record=False):
        pat, _, plens, m_max = _pattern_table(pats, k)
        halo = round_up(m_max + 2 * k, 128)
        rows = staged(corpus, start_row, n, wf, halo, dev)
        dpat = torch.from_numpy(pat).to(dev)
        start = start_row * wf
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
        got = dp_kernel.scan_folded_dp(rows, dpat, bound, start, **kw)
        ref = dp_kernel.scan_folded_dp_ref(rows, dpat, bound, start, **kw)
        torch.cuda.synchronize()
        rec.compare(got, ref, what)
        ms = cuda_ms(lambda: dp_kernel.scan_folded_dp(rows, dpat, bound, start, **kw), reps)
        plain = cuda_ms(lambda: dp_kernel.scan_folded_dp_ref(rows, dpat, bound, start, **kw), plain_reps)
        say(f"phase 2 kernel A {what}: equal, counts {got[:len(pats)].tolist()}, "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
        need(int(got.sum()) > 0, f"kernel A {what}: no matches at all")
        if record:
            owned = int(owned_lanes(n, wf, bound, start).sum())
            rec.measured(ms, plain, rows.numel() + pat.nbytes + 4 * len(plens),
                         band_k1_instr(owned, plens), what)

    pair = [p32.tobytes(), p50.tobytes()]
    full = n_rows * wf - 50 + 1
    for k in (0, 1, 2, 3):
        # k = 1 is phase 5's main-path shape
        case(pair, k, n_rows, 0, full, f"P=2 m=32,50 k={k} R={n_rows}", record=k == 1)
    rng = np.random.default_rng(5)
    lens = [9, 17, 24, 33, 50, 64, 80, 97]
    mixed = [bytes(corpus[p : p + m]) for p, m in zip(rng.integers(0, n_rows * wf // 2, 8), lens)]
    case(mixed, 1, n_rows - 8, 3, 3 * wf + (n_rows - 13) * wf + 4321,
         f"P=8 m=9..97 k=1 R={n_rows - 8} start>0 mid-row bound")
    case(pair, 17, n_rows // 64, 0, n_rows // 64 * wf - 777,
         f"P=2 k=17 (band in global scratch) R={n_rows // 64}",
         reps=2, plain_reps=1)


def phase_corr(rec, dev, n_rows: int = 4096, main_rows: int = 32768) -> None:
    """Kernel B against scan_corr_fused_ref (the TPU formulation), at 4096
    staged rows and at the 32768 rows of a 256 MB main-path chunk."""
    import torch

    from apm_torch.ops import corr_fused
    from apm_torch.ops.corr_engine import build_alphabet
    from apm_torch.utils.corpus import random_corpus, random_pattern

    wf, halo = 8192, 128
    corpus = random_corpus(main_rows * wf + 4096, seed=6, alphabet=b"ACGT")
    rows_main = staged(corpus, 0, main_rows, wf, halo, dev)
    rows = rows_main[:n_rows]  # leading rows: a contiguous view

    def case(pats, what, rows=rows, reps=5, plain_reps=2, record=False, start=0, bound=None):
        n_rows = rows.shape[0]
        m_max = max(len(p) for p in pats)
        pat_raw = np.zeros((len(pats), m_max), np.uint8)
        for i, p in enumerate(pats):
            pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
        alph = build_alphabet(pats)
        km, thr = corr_fused.build_fused_tables(pat_raw, [len(p) for p in pats], alph)
        tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, corr_fused.pick_s(m_max), dev)
        if bound is None:
            bound = n_rows * wf - m_max + 1 - 333
        kw = dict(wf=wf, halo=halo, n_rows=n_rows, p_out=8)
        got = corr_fused.scan_corr_fused(rows, tabs, bound, start, **kw)
        ref = corr_fused.scan_corr_fused_ref(rows, tabs, bound, start, **kw)
        torch.cuda.synchronize()
        rec.compare(got, ref, what)
        need(int(got.sum()) >= len(pats), f"kernel B {what}: planted copies not found")
        ms = cuda_ms(lambda: corr_fused.scan_corr_fused(rows, tabs, bound, start, **kw), reps)
        plain = cuda_ms(lambda: corr_fused.scan_corr_fused_ref(rows, tabs, bound, start, **kw), plain_reps)
        say(f"phase 3 kernel B {what} R={n_rows} ({km.dtype} tables, s_ph={tabs.s_ph}): equal, "
            f"total {int(got.sum())}, kernel {ms:.3f} ms, plain {plain:.3f} ms")
        if record:
            limits = owned_lanes(n_rows, wf, bound)
            rec.measured(ms, plain, rows.numel() + 4 * 8,
                         compare_ops(rows, [(p, 0) for p in pats], limits, wf), what)

    def planted(pats):
        # plant each pattern into the staged rows' corpus copy on the card
        host = rows.cpu().numpy()
        for i, p in enumerate(pats):
            r, lane = (7 + 61 * i) % n_rows, 100 + 37 * i
            host[r, lane : lane + len(p)] = np.frombuffer(p, np.uint8)
        rows.copy_(torch.from_numpy(host))

    pair = [random_pattern(32, seed=1).tobytes(), random_pattern(50, seed=2).tobytes()]
    wide = [random_pattern(50, seed=100 + i).tobytes() for i in range(64)]
    mid = [random_pattern(80, seed=200).tobytes(), random_pattern(70, seed=201).tobytes()]
    short = [random_pattern(m, seed=210 + m).tobytes() for m in (1, 3, 7, 97)]
    planted(pair + wide + mid + short)
    case(pair, "P=2 m=32,50")
    case(pair, "P=2 m=32,50 (a 256 MB chunk)", rows=rows_main, record=True)
    case(wide, "P=64 m=50")
    case(wide, "P=64 m=50 (a 256 MB chunk)", rows=rows_main, reps=3, plain_reps=1)
    case(mid, "P=2 m=70,80")
    # edge cases, small: masked prefixes and m = 97; a view at a row offset
    # with start > 0 and a bound 17 windows into a thread's tile
    case(short, "P=4 m=1,3,7,97", rows=rows[:512], reps=2, plain_reps=1)
    case(pair, "P=2 rows[3:515] start>0 bound inside a tile", rows=rows_main[3:515], reps=2,
         plain_reps=1, start=3 * wf, bound=3 * wf + 500 * wf + 17)
    dense = torch.full((64, wf + halo), ord("A"), dtype=torch.uint8, device=dev)
    case([b"A" * m for m in (1, 3, 8, 50, 97)], "all-A text, A^m patterns (every window hits)",
         rows=dense, reps=2, plain_reps=1)


def phase_myers(rec, dev, n_rows: int = 4096, main_rows: int = 32768) -> None:
    """Kernel C against scan_folded_myers_ref and against kernel A."""
    import torch

    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    wf = 8192
    p32, p50 = random_pattern(32, seed=71), random_pattern(50, seed=72)
    six = [random_pattern(50, seed=80 + i) for i in range(6)]
    corpus = random_corpus(main_rows * wf + 4096, seed=70)
    pos = list(range(1000, len(corpus) - 200, 65_537))
    plant(corpus, p50, pos, k=3, seed=73)
    plant(corpus, p32, [p + 90 for p in pos], k=2, seed=74)
    for i, p in enumerate(six):
        plant(corpus, p, [q + 300 + 70 * i for q in pos], k=3, seed=75 + i)

    def case(pats, k, n, start_row, bound, what, reps=5, plain_reps=1, timed=True, record=False):
        pat, _, plens, m_max = _pattern_table(pats, k)
        alph = tuple(sorted(set(b"".join(pats))))
        need(dp_kernel._myers_mode(k, alph, "int32", "myers", len(plens), m_max),
             f"kernel C {what}: not representable in Myers mode")
        halo = round_up(m_max + 2 * k, 128)
        rows = staged(corpus, start_row, n, wf, halo, dev)
        dpat = torch.from_numpy(pat).to(dev)
        peq = torch.from_numpy(dp_kernel.build_peq(pat, k, m_max, alph)).to(dev)
        start = start_row * wf
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=alph, peq=peq)
        myers = lambda: dp_kernel.scan_folded_dp(rows, dpat, bound, start, dp_impl="myers", **kw)
        band = lambda: dp_kernel.scan_folded_dp(rows, dpat, bound, start, dp_impl="band", **kw)
        plain = lambda: dp_kernel.scan_folded_myers_ref(rows, dpat, bound, start, **kw)
        got = myers()
        torch.cuda.synchronize()
        rec.compare(got, plain(), what + " vs plain")
        rec.compare(got, band(), what + " vs kernel A")
        need(int(got.sum()) > 0, f"kernel C {what}: no matches at all")
        ms, band_ms = cuda_ms(myers, reps), cuda_ms(band, reps)
        plain_ms = cuda_ms(plain, plain_reps) if timed else None
        say(f"phase 2b kernel C {what}: equal to plain and to kernel A, counts "
            f"{got[:len(pats)].tolist()}, kernel {ms:.3f} ms, kernel A {band_ms:.3f} ms, "
            f"plain {'%.3f ms' % plain_ms if timed else 'not timed'}")
        if record:
            owned = int(owned_lanes(n, wf, int(bound), start).sum())
            rec.measured(ms, plain_ms, rows.numel() + peq.numel() * 4 + 4 * len(plens),
                         myers_instr(owned, plens, k), what)

    pair = [p32.tobytes(), p50.tobytes()]
    six_b = [p.tobytes() for p in six]
    full = n_rows * wf - 50 + 1
    for k in (3, 4, 8, 12, 14):
        case(pair, k, n_rows, 0, full, f"P=2 m=32,50 k={k} R={n_rows}")
        # k = 12 on six 50-mers: the k12_myers_dp cell's patterns
        case(six_b, k, n_rows, 0, full, f"P=6 m=50 k={k} R={n_rows}", record=k == 12)
    mid = torch.tensor(3 * wf + (n_rows - 13) * wf + 4321, device=dev)
    case(pair, 5, n_rows - 8, 3, mid,
         f"P=2 k=5 R={n_rows - 8} start>0, mid-row bound in device memory")
    case(six_b, 12, main_rows, 0, main_rows * wf - 50 + 1,
         f"P=6 m=50 k=12 R={main_rows} (a 256 MB chunk)", reps=3, timed=False)


def phase_filter(rec, dev, n_rows: int = 4096, main_rows: int = 32768, edge_rows: int = 512) -> None:
    """Kernel D against scan_filter_ref, fcnt and rowmap cell for cell: the
    main-path shapes at 4096 rows and on the 32768 rows of a 256 MB chunk,
    then edge cases at ``edge_rows`` rows: k = 0 heads of 3 and 7 bytes,
    8-byte and 14-byte pieces (exact, and banded with 7-byte heads), and
    all-A text (every window a candidate, the band at every position)."""
    import torch

    from apm_torch.ops import filter_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    wf = 8192
    corpus = random_corpus(main_rows * wf + 4096, seed=90)
    sets = {
        "short": ([random_pattern(12, seed=91), random_pattern(20, seed=92)], 0),
        "pair": ([random_pattern(32, seed=93), random_pattern(50, seed=94)], 2),
        "120": ([random_pattern(120, seed=95 + i) for i in range(2)], 6),
        "160": ([random_pattern(160, seed=97 + i) for i in range(2)], 12),
        "tiny": ([random_pattern(3, seed=101), random_pattern(7, seed=102)], 0),
        "16": ([random_pattern(16, seed=103), random_pattern(32, seed=104)], 1),
        "84": ([random_pattern(84, seed=105), random_pattern(50, seed=106)], 3),
        "70": ([random_pattern(70, seed=107), random_pattern(120, seed=108)], 5),
    }
    for si, (pats, pk) in enumerate(sets.values()):
        for i, p in enumerate(pats):  # the edge sets' copies apart from the others'
            first = 700 + 211 * i + (53 * si if si < 4 else 50_000 + 1000 * si)
            plant(corpus, p, range(first, len(corpus) - 300, 100_003), k=pk, seed=100 + 10 * si + i)
    dense = {}  # all-A rows by halo

    def case(name, k, n, start_row, bound, what, reps=5, plain_reps=1, record=None, text="random"):
        pats = [p.tobytes() for p in sets[name][0]] if text == "random" else [b"A" * m for m in name]
        _, raw, plens, m_max = _pattern_table(pats, k)
        need(all(filter_kernel.filter_eligible(m, k) for m in plens if m),
             f"kernel D {what}: a pattern is not filtration-eligible")
        halo = round_up(m_max + 2 * k, 128)
        if text == "random":
            rows = staged(corpus, start_row, n, wf, halo, dev)
        else:
            rows = dense.setdefault(halo, torch.full((n, wf + halo), ord("A"), dtype=torch.uint8, device=dev))
        draw = torch.from_numpy(raw).to(dev)
        start = start_row * wf
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
        kern = lambda: filter_kernel.scan_filter(rows, draw, bound, start, **kw)
        plain = lambda: filter_kernel.scan_filter_ref(rows, draw, bound, start, **kw)
        fcnt, rowmap = kern()
        rfcnt, rrowmap = plain()
        torch.cuda.synchronize()
        rec.compare(fcnt, rfcnt, what + " fcnt")
        rec.compare(rowmap, rrowmap, what + " rowmap")
        need(int(fcnt.sum()) > 0, f"kernel D {what}: no candidates at all")
        limits = owned_lanes(n, wf, bound, start)
        if text != "random":
            need(fcnt[: len(pats)].tolist() == [int(limits.sum())] * len(pats),
                 f"kernel D {what}: not every owned window is a candidate")
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, plain_reps) if plain_reps else None
        tiers = sorted({filter_kernel.tier_of(m, k) for m in plens if m})
        say(f"phase 3b kernel D {what} tiers {tiers}: fcnt and rowmap equal, fcnt "
            f"{fcnt[:len(pats)].tolist()}, hot rows {int((rowmap.sum(1) > 0).sum())}, "
            f"kernel {ms:.3f} ms, plain {'%.3f ms' % plain_ms if plain_reps else 'not timed'}")
        if record is not None:
            ops = filter_ops(rows, raw, plens, k, limits, wf)
            rec.measured(ms, plain_ms, rows.numel() + raw.nbytes + 4 * len(plens) * (1 + n), ops, what,
                         keep=record == "keep")

    full = n_rows * wf - 200
    case("short", 0, n_rows, 0, full, f"k=0 m=12,20 R={n_rows}")
    case("pair", 1, n_rows, 0, full, f"k=1 m=32,50 R={n_rows}")
    case("pair", 3, n_rows, 0, full, f"k=3 m=32,50 R={n_rows}", record="keep")
    case("120", 8, n_rows, 0, full, f"k=8 2x120 R={n_rows}", record="print")
    case("160", 16, n_rows - 8, 3, 3 * wf + (n_rows - 13) * wf + 4321,
         f"k=16 2x160 R={n_rows - 8} start>0 mid-row bound")
    case("pair", 3, main_rows, 0, main_rows * wf - 200,
         f"k=3 m=32,50 R={main_rows} (a 256 MB chunk)", reps=3, record="print")
    case("120", 8, main_rows, 0, main_rows * wf - 200,
         f"k=8 2x120 R={main_rows} (a 256 MB chunk)", reps=3, plain_reps=0, record="print")
    # edge cases, small: a bound inside a thread's tile of windows
    e_bound = 3 * wf + (edge_rows - 9) * wf + 17
    for name, k, what in (("tiny", 0, "k=0 m=3,7 (heads under 8 bytes)"),
                          ("16", 1, "k=1 m=16,32 (8-byte pieces)"),
                          ("84", 5, "k=5 m=84,50 (14-byte exact pieces, banded 50)"),
                          ("70", 8, "k=8 m=70,120 (14-byte banded pieces, 7-byte heads)")):
        case(name, k, edge_rows, 3, e_bound, f"{what} R={edge_rows} start>0", reps=3)
    for lens, k in (((32, 16), 1), ((120,), 8)):
        case(lens, k, 64, 0, 63 * wf + 17, f"all-A text, A^{'/A^'.join(map(str, lens))} k={k} R=64 "
             "(every window a candidate)", reps=2, text="all-A")


def batch_groups(corpora, w, wf, halo, bound, gmax=128):
    """``Scanner.count_batch``'s staging of a batch, group by group:
    ``(rows, meta, limits)`` NumPy arrays of ``gmax`` blocks of 8 rows, each
    corpus's blocks folded from that corpus alone, padding blocks (bound 0)
    last. ``bound(n)`` is a corpus's device window bound."""
    from apm_torch.ops.common import fold_corpus

    items = []
    for c in corpora:
        db = bound(len(c))
        items.extend((c, blk, db) for blk in range(-(-db // w) if db > 0 else 0))
    groups = []
    for g0 in range(0, len(items), gmax):
        rows = np.zeros((gmax * 8, wf + halo), np.uint8)
        meta = np.zeros((gmax, 2), np.int32)
        limits = np.zeros((gmax * 8,), np.int32)
        for slot, (c, blk, db) in enumerate(items[g0 : g0 + gmax]):
            rows[slot * 8 : (slot + 1) * 8] = fold_corpus(c, blk * w, 8, wf, halo)
            meta[slot] = (db, blk * w)
            limits[slot * 8 : (slot + 1) * 8] = np.clip(db - blk * w - np.arange(8) * wf, 0, wf)
        groups.append((rows, meta, limits))
    return groups


def mixed_corpora(n, lo, hi, seed, plants=(), alphabet=b"ACGT\n"):
    """``n`` corpora of seeded log-uniform lengths in [lo, hi) bytes, with
    each ``(pattern, step, k)`` of ``plants`` planted every ``step`` bytes."""
    from apm_torch.utils.corpus import plant, random_corpus

    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)
    out = []
    for i, length in enumerate(lens):
        c = random_corpus(int(length), seed=seed + 1 + i, alphabet=alphabet)
        for j, (p, step, k) in enumerate(plants):
            p = np.frombuffer(p, np.uint8)
            plant(c, p, range(700 + 331 * j, len(c) - len(p) - 1, step), k=k, seed=seed + j)
        out.append(c)
    return out


def phase_batch_dp(rec, dev, n_corpora: int = 40, lo: int = 64 << 10, hi: int = 4 << 20) -> None:
    """Kernel #4 (the batch mode of kernels A and C) against its plain
    version, every group of ``count_batch``'s staging of 40 mixed corpora:
    1024 staged rows (128 blocks) of 8192-window rows per group, the last
    group ending in padding blocks."""
    import torch

    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import random_pattern

    wf = 8192
    pair = [random_pattern(32, seed=301).tobytes(), random_pattern(50, seed=302).tobytes()]
    corpora = mixed_corpora(n_corpora, lo, hi, 303, [(pair[1], 40_000, 1), (pair[0], 90_000, 0)])
    alph = tuple(sorted(set(b"".join(pair))))
    for k in (1, 3, 12):
        pat, _, plens, m_max = _pattern_table(pair, k)
        halo = round_up(m_max + 2 * k, 128)
        groups = batch_groups(corpora, 8 * wf, wf, halo,
                              lambda n: max(0, min(n - m_max + 1, n - k)))
        need(groups[-1][1][-1, 0] == 0, "phase 2c: the last group has no padding block")
        dpat = torch.from_numpy(pat).to(dev)
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=alph)
        mode = "myers" if dp_kernel._is_myers(k, m_max, plens, alph, "auto") else "band"
        total = 0
        for gi, (rows, meta, _) in enumerate(groups):
            drows, dmeta = torch.from_numpy(rows).to(dev), torch.from_numpy(meta).to(dev)
            got = dp_kernel.scan_folded_dp_batch(drows, dpat, dmeta, **kw)
            ref = dp_kernel.scan_folded_dp_batch_ref(drows, dpat, dmeta, **kw)
            torch.cuda.synchronize()
            rec.compare(got, ref, f"k={k} group {gi}")
            total += int(got.sum())
        need(total >= len(corpora), f"phase 2c k={k}: plants missed ({total})")
        rows, meta, limits = groups[0]
        drows, dmeta = torch.from_numpy(rows).to(dev), torch.from_numpy(meta).to(dev)
        ms = cuda_ms(lambda: dp_kernel.scan_folded_dp_batch(drows, dpat, dmeta, **kw), 5)
        plain = cuda_ms(lambda: dp_kernel.scan_folded_dp_batch_ref(drows, dpat, dmeta, **kw), 1)
        what = f"k={k} ({mode}) R={rows.shape[0]}, {len(corpora)} corpora"
        say(f"phase 2c kernel #4 {what}: {len(groups)} groups equal, total {total}, "
            f"first group kernel {ms:.3f} ms, plain {plain:.3f} ms")
        if k == 1:  # count_batch's k = 1 main path
            owned = int(limits.sum())
            rec.measured(ms, plain, rows.nbytes + meta.nbytes + pat.nbytes + 4 * meta.shape[0] * len(plens),
                         band_k1_instr(owned, plens), what)


def phase_mask(rec, dev, n_rows: int = 512, edge_rows: int = 40) -> None:
    """Kernel #6 (the mask kernels, ``csrc/dp_mask.cu``) against its plain
    version at find's gather shape (FIND_BATCH rows), a mid-row bound,
    band k = 1 and Myers k = 3: counts and the (R, P, wf) verdicts byte for
    byte, each timed against its bound (the recount from the work: band
    cells at two DPX instructions a window, Myers steps at Hyyro's update,
    one update a window pair where 2k + 1 <= 15).
    Also times the bit pack and the per-row top-k that follow it on find's
    path. Edge cases at ``edge_rows`` rows: k = 16 and 17 (the register
    limit, then the scratch path), patterns shorter than k, NUL and bytes
    outside the alphabet, all-A text (every window a hit), an odd wf (byte
    stores, unaligned rows), Myers at k = 8 (two chains, not packed), a
    40 000-byte pattern (its table read from global memory), 200 patterns
    (two launches) and a bound in device memory."""
    import torch

    from apm_torch.ops import dp_kernel, fused
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    wf = 8192
    pair = [random_pattern(32, seed=311).tobytes(), random_pattern(50, seed=312).tobytes()]
    corpus = random_corpus(n_rows * wf + 4096, seed=313)
    plant(corpus, np.frombuffer(pair[1], np.uint8), range(900, len(corpus) - 100, 9_001), k=1, seed=314)
    plant(corpus, np.frombuffer(pair[0], np.uint8), range(5000, len(corpus) - 100, 30_011), k=0)
    alph = tuple(sorted(set(b"".join(pair))))
    for k in (1, 3):
        pat, _, plens, m_max = _pattern_table(pair, k)
        halo = round_up(m_max + 2 * k, 128)
        rows = staged(corpus, 0, n_rows, wf, halo, dev)
        dpat = torch.from_numpy(pat).to(dev)
        bound = (n_rows - 5) * wf + 4321
        # the Scanner passes its own PEQ table, as here
        peq = torch.from_numpy(dp_kernel.build_peq(pat, k, m_max, alph)).to(dev)
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=alph, peq=peq)
        mode = "myers" if dp_kernel._is_myers(k, m_max, plens, alph, "auto") else "band"
        counts, mask = dp_kernel.scan_folded_dp_mask(rows, dpat, bound, 0, **kw)
        rc, rm = dp_kernel.scan_folded_dp_mask_ref(rows, dpat, bound, 0, **kw)
        torch.cuda.synchronize()
        what = f"k={k} ({mode}) R={n_rows} mid-row bound"
        rec.compare(counts, rc, what + " counts")
        rec.compare(mask, rm, what + " mask")
        need(int(mask.sum()) == int(counts.sum()) > 0, f"kernel #6 {what}: mask and counts disagree")
        ms = cuda_ms(lambda: dp_kernel.scan_folded_dp_mask(rows, dpat, bound, 0, **kw), 9)
        plain = cuda_ms(lambda: dp_kernel.scan_folded_dp_mask_ref(rows, dpat, bound, 0, **kw), 1)
        pack = cuda_ms(lambda: fused._pack_mask_bits(mask, len(pair)), 5)
        topk = cuda_ms(lambda: fused._row_topk_positions(mask, len(pair), wf, fused.POS_CAP), 5)
        say(f"phase 2d kernel #6 {what}: counts and {mask.numel()}-byte mask equal, counts "
            f"{counts[:2].tolist()}, kernel {ms:.3f} ms, plain {plain:.3f} ms; then on find's "
            f"path: bit pack {pack:.3f} ms, per-row top-{fused.POS_CAP} {topk:.3f} ms")
        owned = int(owned_lanes(n_rows, wf, bound).sum())
        instr = mask_band_instr(owned, plens, k) if mode == "band" else mask_myers_instr(owned, plens, k)
        rec.measured(ms, plain, rows.numel() + pat.nbytes + 4 * len(plens) + mask.numel(),
                     instr, what, keep=k == 1)
    # edge cases, small: each against the plain version, counts and mask
    ew = 1024
    base = random_corpus(edge_rows * ew + 4096, seed=315, alphabet=b"ACGT")
    foreign = random_corpus(edge_rows * ew + 4096, seed=316, alphabet=b"ACGT\x00N\xff")
    short = lambda k: [bytes(base[3000 : 3000 + m]) for m in (max(k - 1, 1), k, 12)]
    mixed = [bytes(base[3000:3040]), bytes(base[7000:7012]), b"ACGTTGCAAC"]
    for i, p in enumerate(mixed[:2]):
        foreign[3000 + 4000 * i : 3000 + 4000 * i + len(p)] = np.frombuffer(p, np.uint8)
    all_a = np.full_like(base, ord("A"))
    cases = [(16, "band", base, mixed, ew), (17, "band", base, mixed, ew),
             (2, "band", base, short(2), ew), (3, "myers", base, short(3), ew),
             (1, "band", foreign, mixed, ew), (2, "myers", foreign, mixed, ew),
             (1, "band", all_a, [b"A" * 40, b"A" * 2], ew), (3, "myers", all_a, [b"A" * 40, b"A" * 4], ew),
             (1, "band", base, mixed, ew - 1), (3, "myers", base, mixed, ew - 1),
             (8, "myers", base, mixed, ew),  # too wide to pack: two chains a thread
             (1, "band", base, [bytes(base[3000:43000]), b"ACGTTGCAAC"], ew),  # table from global
             (1, "band", base, [bytes(base[q : q + 50]) for q in range(1000, 20_400, 97)], ew)]
    for k, impl, text, pats, w in cases:
        pat, _, plens, m_max = _pattern_table(pats, k)
        halo = round_up(m_max + 2 * k, 128)
        rows = staged(text, 1, edge_rows, w, halo, dev)
        dpat = torch.from_numpy(pat).to(dev)
        bound = w + (edge_rows - 4) * w + 333
        kw = dict(k=k, m_max=m_max, wf=w, halo=halo, plens=plens, alphabet=tuple(b"ACGT"), dp_impl=impl)
        need(dp_kernel._is_myers(k, m_max, plens, tuple(b"ACGT"), impl) == (impl == "myers"),
             f"phase 2d edge k={k}: not in {impl} mode")
        ref = dp_kernel.scan_folded_dp_mask_ref(rows, dpat, bound, w, **kw)
        live = [m for m in plens if m]
        what = f"edge k={k} ({impl}) m={live if len(live) < 8 else f'{len(live)} x {live[0]}'} wf={w}"
        for b in (bound, torch.tensor(bound, device=dev)):
            got = dp_kernel.scan_folded_dp_mask(rows, dpat, b, w, **kw)
            torch.cuda.synchronize()
            rec.compare(got[0], ref[0], what + " counts")
            rec.compare(got[1], ref[1], what + " mask")
        need(int(ref[0].sum()) > 0, f"kernel #6 {what}: no matches at all")
        say(f"phase 2d kernel #6 {what}: counts and mask equal (bound as a value and on the "
            f"device), counts {ref[0][:len(pats)].tolist()}")


def phase_corr_batch(rec, dev, n_corpora: int = 40, lo: int = 64 << 10, hi: int = 4 << 20) -> None:
    """Kernel #8 (the batch mode of kernel B) against its plain version on
    every group of count_batch's staging of 40 mixed corpora (1024 rows per
    group), at P = 2, P = 64 (int8 tables) and m = 70, 80 (32-phase
    tables), row limits from each corpus's bound; edge cases on 6 corpora:
    patterns of 1, 3 and 7 bytes (masked prefix words), and all-A text
    against A^m (every owned window hits). The recorded case is timed
    beside an empty launch of the same grid, which is what holds a kernel
    whose bound is a few microseconds."""
    import torch

    from apm_torch.ops import corr_fused
    from apm_torch.ops.corr_engine import build_alphabet
    from apm_torch.utils.corpus import random_pattern

    wf, halo = 8192, 128
    pair = [random_pattern(32, seed=321).tobytes(), random_pattern(50, seed=322).tobytes()]
    wide = [random_pattern(50, seed=330 + i).tobytes() for i in range(64)]
    mid = [random_pattern(80, seed=323).tobytes(), random_pattern(70, seed=324).tobytes()]
    short = [random_pattern(m, seed=326 + m).tobytes() for m in (1, 3, 7)]
    plants = [(p, 200_003 + 1009 * i, 0) for i, p in enumerate(pair + wide[:6] + mid)]
    corpora = mixed_corpora(n_corpora, lo, hi, 325, plants, alphabet=b"ACGT")
    few = corpora[:6]
    all_a = mixed_corpora(6, lo, hi, 327, alphabet=b"A")
    cases = ((pair, "P=2 m=32,50", corpora), (wide, "P=64 m=50", corpora),
             (mid, "P=2 m=70,80", corpora), (short, "P=3 m=1,3,7", few),
             ([b"A" * m for m in (1, 3, 8, 50)], "all-A text, A^1/A^3/A^8/A^50", all_a))
    for pats, name, cs in cases:
        m_max = max(len(p) for p in pats)
        pat_raw = np.zeros((len(pats), m_max), np.uint8)
        for i, p in enumerate(pats):
            pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
        alph = build_alphabet(pats)
        km, thr = corr_fused.build_fused_tables(pat_raw, [len(p) for p in pats], alph)
        tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, corr_fused.pick_s(m_max), dev)
        groups = batch_groups(cs, 8 * wf, wf, halo, lambda n: n - m_max + 1)
        kw = dict(wf=wf, halo=halo, p_out=max(8, len(pats)))
        total = owned = 0
        for gi, (rows, _, limits) in enumerate(groups):
            drows, dlim = torch.from_numpy(rows).to(dev), torch.from_numpy(limits).to(dev)
            got = corr_fused.scan_corr_batch_fused(drows, tabs, dlim, **kw)
            ref = corr_fused.scan_corr_batch_fused_ref(drows, tabs, dlim, **kw)
            torch.cuda.synchronize()
            rec.compare(got, ref, f"{name} group {gi}")
            total += int(got.sum())
            owned += int(limits.sum())
        if cs is all_a:
            need(total == owned * len(pats), f"phase 3c {name}: {total} != every owned window")
        else:
            need(total >= len(cs), f"phase 3c {name}: plants missed ({total})")
        rows, _, limits = groups[0]
        drows, dlim = torch.from_numpy(rows).to(dev), torch.from_numpy(limits).to(dev)
        ms = cuda_ms(lambda: corr_fused.scan_corr_batch_fused(drows, tabs, dlim, **kw), 5)
        plain = cuda_ms(lambda: corr_fused.scan_corr_batch_fused_ref(drows, tabs, dlim, **kw), 2)
        what = f"{name} R={rows.shape[0]}, {len(cs)} corpora"
        say(f"phase 3c kernel #8 {what} ({km.dtype} tables, s_ph={tabs.s_ph}): {len(groups)} "
            f"groups equal, total {total}, first group kernel {ms:.3f} ms, plain {plain:.3f} ms")
        if pats is pair:  # count_batch's k = 0 main path
            bound = rec.measured(ms, plain, rows.nbytes + limits.nbytes + 4 * (rows.shape[0] // 8) * kw["p_out"],
                                 compare_ops(drows, [(p, 0) for p in pats], limits, wf), what)
            # a kernel that does nothing, launched with #8's grid and block
            from apm_torch.ops._build import check, library

            grid, lib = corr_fused.batch_grid(dev, rows.shape[0], wf), library()
            stream = torch.cuda.current_stream(dev).cuda_stream
            threads = corr_fused.batch_threads(wf)
            empty = cuda_ms(lambda: check(lib.apm_empty_launch(grid, threads, stream), "apm_empty_launch"), 20)
            say(f"phase 3c kernel #8 beside its bound {bound:.4f} ms: an empty launch of the same "
                f"grid ({grid} blocks) takes {empty:.4f} ms (median of 20, CUDA events), the call "
                f"{ms:.3f} ms (chip_compare.py reads the kernel alone)")


def phase_dyn(rec, dev, n_rows: int = 4096) -> None:
    """Kernel #9 (kernel A's dynamic-length entry, ``scan_folded``) against
    ``scan_folded_ref`` and against kernel A's count mode over the same
    lengths: P = 8 (four padding rows), mixed lengths, k in {0, 1, 3},
    start > 0 and a mid-row bound, with the lengths, start and bound in
    device memory. Each k runs twice through one length tensor holding
    different values: nothing about the lengths is kept on the host."""
    import torch

    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import plant, random_corpus

    wf = 8192
    corpus = random_corpus((n_rows + 3) * wf + 4096, seed=370)
    rng = np.random.default_rng(371)
    lens = [12, 30, 41, 64]
    pats = [bytes(corpus[p : p + m]) for p, m in zip(rng.integers(0, n_rows * wf // 2, 4), lens)]
    for i, p in enumerate(pats):
        plant(corpus, np.frombuffer(p, np.uint8), range(900 + 313 * i, len(corpus) - 100, 50_021 + 17 * i),
              k=1, seed=372 + i)
    start = 3 * wf
    bound = start + (n_rows - 5) * wf + 4321
    for k in (0, 1, 3):
        pat, _, plens, m_max = _pattern_table(pats, k)
        halo = round_up(m_max + 2 * k, 128)
        rows = staged(corpus, 3, n_rows, wf, halo, dev)
        dpat = torch.from_numpy(pat).to(dev)
        dplen = torch.zeros((len(plens),), dtype=torch.int32, device=dev)
        dbound = torch.tensor(bound, dtype=torch.int32, device=dev)
        dstart = torch.tensor(start, dtype=torch.int32, device=dev)
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo)
        dyn = lambda: dp_kernel.scan_folded(rows, dpat, dplen, dbound, dstart, **kw)
        plain = lambda: dp_kernel.scan_folded_ref(rows, dpat, dplen, dbound, dstart, **kw)
        # the second vector drops two patterns and halves a third: a prefix
        for now in (plens, (plens[0], 0, plens[2] // 2, plens[3], 0, 0, 0, 0)):
            dplen.copy_(torch.tensor(now, dtype=torch.int32))
            band = lambda: dp_kernel.scan_folded_dp(rows, dpat, bound, start, plens=tuple(now), **kw)
            got = dyn()
            torch.cuda.synchronize()
            what = f"k={k} P=8 lengths {list(now)} R={n_rows} start>0 mid-row bound"
            rec.compare(got, plain(), what + " vs plain")
            rec.compare(got, band(), what + " vs kernel A")
            need(int(got.sum()) > 0, f"kernel #9 {what}: no matches at all")
            say(f"phase 2e kernel #9 {what}: equal to plain and to kernel A, counts {got.tolist()}")
        ms, band_ms, plain_ms = cuda_ms(dyn, 5), cuda_ms(band, 5), cuda_ms(plain, 1)
        say(f"phase 2e kernel #9 k={k} (last lengths): kernel {ms:.3f} ms, kernel A (static "
            f"lengths) {band_ms:.3f} ms, plain {plain_ms:.3f} ms")
        if k == 1:
            owned = int(owned_lanes(n_rows, wf, bound, start).sum())
            # rows, table, lengths, bound and start in; the counts out
            rec.measured(ms, plain_ms, rows.numel() + pat.nbytes + 4 * len(plens) + 8 + 4 * len(plens),
                         band_k1_instr(owned, now), f"k=1 P=8 R={n_rows}")


def phase_pieces(rec, dev, n_rows: int = 4096, main_rows: int = 32768) -> None:
    """Kernel #7 (the fused piece scan, ``csrc/corr_pieces.cu``) against
    ``scan_pieces_fused_ref``, fcnt and row map cell for cell, on the
    Scanner's own piece tables of the reference-shaped set (1 x 32 + 5 x
    50) under ``corr_impl="fused"`` at k = 1, 2 and 4: 4096 rows with
    start > 0, a mid-row bound and two staging-padding rows, and the 32768
    rows of a 256 MB chunk. Each is timed beside the piece conv
    (``scan_pieces_conv``, the phase 1 of ``corr_impl="auto"``) on the same
    rows and pieces; that conv covers other positions past ``wf``, so its
    totals are not compared."""
    import torch

    import apm_torch
    from apm_torch.models.pipeline import make_plan
    from apm_torch.ops import corr_engine, corr_fused
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    wf, halo = 8192, 128
    p32, p50 = random_pattern(32, seed=11), random_pattern(50, seed=12)
    ref_set = [p32.tobytes()] + [p50.tobytes()] * 5
    corpus = random_corpus(main_rows * wf + 4096, seed=360)
    plant(corpus, p50, range(5000, len(corpus) - 4096, 1 << 20), k=2, seed=361)
    plant(corpus, p32, range(70_000, len(corpus) - 4096, 1 << 21), k=1, seed=362)
    rows_main = staged(corpus, 0, main_rows, wf, halo, dev)
    for k in (1, 2, 4):
        sc = apm_torch.Scanner(ref_set, k, apm_torch.ApmConfig(device=str(dev), corr_impl="fused"))
        plan = make_plan(sc, len(corpus))
        need((plan.wf, plan.halo) == (wf, halo) and sc._routes(plan)[1] == "fused",
             f"kernel #7 k={k}: the plan does not run the fused piece scan")
        tabs = sc._device_fp1_fused(plan.plens_filter)
        pkern, pthr, owner, stride = sc._device_fp1(plan.plens_filter)
        alph = sc._device_tables(fused_needed=False)["alph"]
        cases = (
            (rows_main[3 : 3 + n_rows], 3 * wf, 3 * wf + (n_rows - 5) * wf + 4321, n_rows - 2,
             f"k={k} R={n_rows} start>0 mid-row bound"),
            (rows_main, 0, plan.dev_bound, main_rows, f"k={k} R={main_rows} (a 256 MB chunk)"),
        )
        for rows, start, bound, live_rows, what in cases:
            kw = dict(wf=wf, halo=halo, n_rows=live_rows)
            g_rows = corr_engine._group_rows(wf + halo, len(alph), live_rows)
            kern = lambda: corr_fused.scan_pieces_fused(rows, tabs, bound, start, **kw)
            plain = lambda: corr_fused.scan_pieces_fused_ref(rows, tabs, bound, start, **kw)
            conv = lambda: corr_engine.scan_pieces_conv(
                rows, pkern, pthr, owner, alph, bound, start, wf=wf, w_kern=pkern.shape[0],
                n_rows=live_rows, g_rows=g_rows, stride=stride,
            )
            fcnt, rowmap = kern()
            rf, rr = plain()
            torch.cuda.synchronize()
            rec.compare(fcnt, rf, what + " fcnt")
            rec.compare(rowmap, rr, what + " rowmap")
            need(int(fcnt.sum()) > 0, f"kernel #7 {what}: no piece hits at all")
            ms, plain_ms, conv_ms = cuda_ms(kern, 5), cuda_ms(plain, 1), cuda_ms(conv, 3)
            say(f"phase 3d kernel #7 {what}: piece lengths {tabs.plen.tolist()}, fcnt and rowmap "
                f"equal, fcnt {fcnt[:2].tolist()}, hot rows {int((rowmap.sum(1) > 0).sum())}, "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, piece conv {conv_ms:.3f} ms")
            if k == 1 and start == 0:  # the 256 MB k = 1 cell's chunk
                r = np.arange(rows.shape[0])
                live = (r < live_rows) & (start + r * wf < bound)
                limits = np.where(live, wf + corr_fused._PIECE_REACH, 0)
                piece = tabs.piece.cpu().numpy()
                seqs = [(piece[q, :l], 0) for q, l in enumerate(tabs.plen.tolist()) if l > 0]
                ops = compare_ops(rows, seqs, limits, wf, width=wf + corr_fused._PIECE_REACH)
                out_bytes = 4 * tabs.n_pat * (1 + rows.shape[0])
                in_bytes = rows.numel() + tabs.piece.numel() + 8 * tabs.plen.numel()
                rec.measured(ms, plain_ms, in_bytes + out_bytes, ops, what)

    # edge cases on tables built from pattern sets directly: 8- and 9-byte
    # pieces and m = 65 (k = 1 pieces of 16, 17 and 65 bytes; the 1-, 3-
    # and 7-byte patterns have none), all-A text where every position hits,
    # and P = 64 (128 pieces), timed at 4096 rows
    from apm_torch.ops.filter_kernel import tier_of

    dense = torch.full((64, wf + halo), ord("A"), dtype=torch.uint8, device=dev)
    edges = (
        ([random_pattern(m, seed=380 + m).tobytes() for m in (1, 3, 7, 16, 17, 65)],
         rows_main[5:517], "k=1 m=1,3,7,16,17,65 R=512"),
        ([b"A" * 32, b"A" * 50], dense, "k=1 all-A text, A^32 and A^50 (every position hits)"),
        ([random_pattern(50, seed=400 + i).tobytes() for i in range(64)], rows_main[:n_rows],
         f"k=1 P=64 m=50 R={n_rows}"),
    )
    for pats, rows, what in edges:
        host = rows.cpu().numpy()
        for i, p in enumerate(pats):  # one exact copy each, a few rows apart
            r, lane = (3 + 7 * i) % rows.shape[0], 200 + 61 * i
            host[r, lane : lane + len(p)] = np.frombuffer(p, np.uint8)
        rows = torch.from_numpy(host).to(dev)
        m_max = max(len(p) for p in pats)
        p_pad = -(-len(pats) // 8) * 8
        raw = np.zeros((p_pad, m_max), np.uint8)
        for i, p in enumerate(pats):
            raw[i, : len(p)] = np.frombuffer(p, np.uint8)
        plens = tuple(len(p) if tier_of(len(p), 1) else 0 for p in pats) + (0,) * (p_pad - len(pats))
        alph = corr_engine.build_alphabet(pats)
        tabs = corr_fused.PieceTables.from_numpy(
            *corr_fused.build_fused_piece_tables(raw, plens, 1, alph), alph, dev)
        bound, kw = rows.shape[0] * wf - 999, dict(wf=wf, halo=halo, n_rows=rows.shape[0])
        kern = lambda: corr_fused.scan_pieces_fused(rows, tabs, bound, 0, **kw)
        plain = lambda: corr_fused.scan_pieces_fused_ref(rows, tabs, bound, 0, **kw)
        fcnt, rowmap = kern()
        rf, rr = plain()
        torch.cuda.synchronize()
        rec.compare(fcnt, rf, what + " fcnt")
        rec.compare(rowmap, rr, what + " rowmap")
        need(int((fcnt[: len(pats)] > 0).sum()) == sum(1 for m in plens if m),
             f"kernel #7 {what}: a pattern's planted copy was not found")
        ms, plain_ms = cuda_ms(kern, 3), cuda_ms(plain, 1)
        say(f"phase 3d kernel #7 {what}: {int((tabs.plen > 0).sum())} pieces of lengths "
            f"{sorted(set(tabs.plen[tabs.plen > 0].tolist()))}, fcnt and rowmap equal, fcnt total "
            f"{int(fcnt.sum())}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")


def phase_e2e_batch(main, dev, n_corpora: int = 64, lo: int = 1 << 19, hi: int = 8 << 20) -> None:
    """Scanner.count_batch end to end on 64 corpora of 0.5 to 8 MB, the
    reference-shaped set, k = 0, 1 and 3: each row equal to ``sc.count(c)``
    on the same Scanner and, for up to three corpora under 1 MB, to the
    oracle; MB/s and corpora/s beside the loop of ``count``."""
    import apm_torch
    from apm_torch.utils.corpus import random_pattern

    p32, p50 = random_pattern(32, seed=341).tobytes(), random_pattern(50, seed=342).tobytes()
    pats = [p32] + [p50] * 5
    corpora = mixed_corpora(n_corpora, lo, hi, 343, [(p50, 1 << 18, 1), (p32, 1 << 19, 0)])
    total = sum(len(c) for c in corpora)
    small = sorted((c for c in corpora if len(c) < 1 << 20), key=len)[:3]
    for k, expect in ((0, ["corr_batch"]), (1, ["dp_batch"]), (3, ["dp_batch"])):
        sc = apm_torch.Scanner(pats, k, apm_torch.ApmConfig(device=str(dev)))
        got = main.run(f"count_batch {n_corpora} corpora k={k}", expect, lambda: sc.count_batch(corpora))
        t0 = time.perf_counter()
        loop = np.stack([sc.count(c) for c in corpora])
        loop_s = time.perf_counter() - t0
        need(got.tolist() == loop.tolist(), f"count_batch k={k}: differs from the loop of count")
        for c in small:
            want = _dedup_oracle(c, pats, k)
            need(sc.count_batch([c])[0].tolist() == want, f"count_batch k={k}: {len(c)} B != oracle")
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            sc.count_batch(corpora)
            secs.append(time.perf_counter() - t0)
        batch_s = min(secs)
        say(f"phase 7 count_batch k={k}, {n_corpora} corpora, {total / 1e6:.1f} MB: rows == count "
            f"loop, {len(small)} corpora under 1 MB == oracle, counts of corpus 0 {got[0].tolist()}; "
            f"count_batch {total / batch_s / 1e6:.1f} MB/s, {n_corpora / batch_s:.1f} corpora/s "
            f"(best of 2, {batch_s * 1e3:.1f} ms); loop of count {total / loop_s / 1e6:.1f} MB/s, "
            f"{n_corpora / loop_s:.1f} corpora/s (one pass)")
        say(f"phase 7 count_batch k={k} split: {batch_split(sc, corpora)}")
        if k == 0:  # the batched conv (apm's scan_corr_batch), plain PyTorch
            scc = apm_torch.Scanner(pats, 0, apm_torch.ApmConfig(device=str(dev), corr_impl="conv"))
            gotc = main.run(f"count_batch {n_corpora} corpora k=0 corr_impl=conv", [],
                            lambda: scc.count_batch(corpora))
            need(gotc.tolist() == got.tolist(), "count_batch k=0 conv: differs from kernel #8's route")
            secs = []
            for _ in range(2):
                t0 = time.perf_counter()
                scc.count_batch(corpora)
                secs.append(time.perf_counter() - t0)
            say(f"phase 7 count_batch k=0 corr_impl=conv: == kernel #8's route, "
                f"{total / min(secs) / 1e6:.1f} MB/s, {n_corpora / min(secs):.1f} corpora/s (best of 2)")


HOST_SPANS = ("fold", "fetch", "EOF tail")


def batch_split(sc, corpora) -> str:
    """Where one ``sc.count_batch(corpora)`` spends its time, from the
    Scanner's own spans of that call (``Scanner.meter.trace``). The host
    spans (fold, EOF tail, fetch) run one after another, the native EOF
    tails after every launch and before the fetch, so they overlap the
    device; the device spans (copy, the route's launches) run under the
    host's: each clock's sum must stay within the call's own time."""
    sc.meter.trace = True
    try:
        t0 = time.perf_counter()
        sc.count_batch(corpora)
        call_ms = (time.perf_counter() - t0) * 1e3
        spans = dict(sc.meter.last_spans)
    finally:
        sc.meter.trace = False
    host = sum(v for n, v in spans.items() if n in HOST_SPANS)
    device = sum(v for n, v in spans.items() if n not in HOST_SPANS)
    need(host <= call_ms and device <= call_ms,
         f"count_batch spans: host {host:.1f} / device {device:.1f} ms > the call's {call_ms:.1f} ms")
    order = [n for n in spans if n in HOST_SPANS]
    need(order == ["fold", "EOF tail", "fetch"], f"count_batch host spans in the order {order}")
    tail = spans.get("EOF tail", 0.0)
    return (f"one traced call {call_ms:.1f} ms: " + ", ".join(f"{n} {v:.3f} ms" for n, v in spans.items())
            + f"; host spans {host:.1f} ms, device spans {device:.1f} ms (each within the call); "
            f"the native EOF tails, before the fetch, {tail:.1f} ms = {100 * tail / call_ms:.1f} % "
            f"of the call")


def _prefix_positions(c, pat, k, n):
    """Oracle positions j < n of ``pat`` in corpus ``c`` (windows that end
    before EOF: the prefix carries m - 1 + k context bytes)."""
    from apm_torch.utils.oracle import banded_distances

    d = banded_distances(c[: n + len(pat) - 1 + k], pat, k)
    return np.nonzero(d[:n] <= k)[0].tolist()


def phase_e2e_find(main, dev, mb: int = 256, dense_mb: int = 4, cut_mb: int = 32) -> None:
    """Scanner.find end to end: a sparse cell (``mb`` MB, k = 1, the
    reference-shaped set, one planted 50-mer per MB: kernel D, then #6) and
    two dense cells (``dense_mb`` MB, one 9-byte pattern at k = 2, which
    filtration cannot take: the mask sweep). Gates: per pattern as many
    positions as ``count``, the positions of a 1 MB prefix equal to the
    oracle's, and, on a ``cut_mb`` MB cut of the sparse cell, the kernels'
    positions equal to the plain versions' on the card."""
    import apm_torch
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    cfg = lambda **kw: apm_torch.ApmConfig(device=str(dev), **kw)

    def gates(name, sc, c, pats, k, mbps_reps=2):
        pos = sc.find(c)  # a repeat, as gated
        counts = sc.count(c)
        need([len(p) for p in pos] == counts.tolist(),
             f"find {name}: {[len(p) for p in pos]} positions, count {counts.tolist()}")
        n = min(len(c), 1 << 20)
        for p, got in zip(pats, pos):
            want = _prefix_positions(c, np.frombuffer(p, np.uint8), k, n)
            need(got[got < n].tolist() == want, f"find {name}: 1 MB prefix != oracle")
        secs = []
        for _ in range(mbps_reps):
            t0 = time.perf_counter()
            sc.find(c)
            secs.append(time.perf_counter() - t0)
        return counts, len(c) / min(secs) / 1e6

    size = mb << 20
    p32, p50 = random_pattern(32, seed=351).tobytes(), random_pattern(50, seed=352).tobytes()
    pats = [p32] + [p50] * 5
    c = random_corpus(size, seed=353)
    plant(c, np.frombuffer(p50, np.uint8), range(5000, size - 4096, 1 << 20), k=1, seed=354)
    sc = apm_torch.Scanner(pats, 1, cfg())
    main.run(f"find {mb} MB k=1 sparse", ["filter_pieces", "dp_mask"], lambda: sc.find(c))
    route = sc.last_find
    counts, mbps = gates(f"{mb} MB sparse", sc, c, pats, 1)
    need(counts[1] >= mb - 2, f"find {mb} MB sparse: plants missed")
    cut = c[: cut_mb << 20]
    kern = sc.find(cut)
    plain = apm_torch.Scanner(pats, 1, cfg(backend="torch")).find(cut)
    need([p.tolist() for p in kern] == [p.tolist() for p in plain],
         f"find {cut_mb} MB cut: kernels != plain versions")
    say(f"phase 8 find {mb} MB k=1 sparse: positions == count {counts.tolist()}, 1 MB prefix == "
        f"oracle, {cut_mb} MB cut == plain versions on the card; branches {route}; "
        f"{mbps:.1f} MB/s (best of 2, warm writable: the hash, then the cached rows)")

    nine = random_pattern(9, seed=355).tobytes()
    cells = (
        # random text: every 1024-window row holds a few hits and more rows
        # are hot than FIND_BATCH: the gpos decode
        ("random ACGT", random_corpus(dense_mb << 20, seed=356, alphabet=b"ACGT"), nine,
         dict(block_windows=8192), "gpos"),
        # every window matches: rows pass POS_CAP, the packed-mask fallback
        ("all-A", np.full(dense_mb << 20, ord("A"), np.uint8), b"A" * 9, {}, "bits"),
    )
    for name, d, pat, extra, branch in cells:
        sc = apm_torch.Scanner([pat], 2, cfg(**extra))
        main.run(f"find {dense_mb} MB k=2 dense {name}", ["dp_mask"], lambda: sc.find(d))
        route = sc.last_find
        need(set(route) == {"dense"} and route["dense"][branch] > 0,
             f"find dense {name}: branches {route}, expected {branch}")
        counts, mbps = gates(f"{dense_mb} MB dense {name}", sc, d, [pat], 2)
        say(f"phase 8 find {dense_mb} MB k=2 dense {name} (m = 9, the mask sweep): {counts[0]} "
            f"positions == count, 1 MB prefix == oracle; branches {route}; {mbps:.1f} MB/s (warm "
            f"writable)")


def phase_e2e_k0(main, dev, mb: int = 256, conv: bool = False):
    """Phase 4 (and 4b with ``conv``): ``count`` at k = 0 on ``mb`` MB.
    Returns the cell's ``(corpus, patterns, counts)``."""
    import torch

    import apm_torch
    from apm_torch.utils.corpus import random_pattern
    from apm_torch.utils.oracle import count_matches

    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT\n", dtype=np.uint8)
    syn = alpha[rng.integers(0, 5, size=mb << 20)]
    p32, p50 = random_pattern(32, seed=11), random_pattern(50, seed=12)
    for pos in range(4096, (mb - 1) << 20, 1 << 20):  # one exact copy per MB
        syn[pos : pos + 50] = p50
    pats = [p32.tobytes()] + [p50.tobytes()] * 5
    sc = apm_torch.Scanner(pats, 0, apm_torch.ApmConfig(device=str(dev)))
    t0 = time.perf_counter()
    counts = main.run(f"{mb} MB k=0", ["corr_fused"], lambda: sc.count(syn))
    first_ms = (time.perf_counter() - t0) * 1e3
    dev_bound = sc.device_window_bound(len(syn))
    syn_b = syn.tobytes()
    tail = count_matches(syn[dev_bound:], pats, 0)
    expected = [
        host_exact_count(syn_b[: dev_bound + len(p) - 1], p) + t
        for p, t in zip(pats, tail)
    ]
    del syn_b
    need(counts.tolist() == expected, f"{mb} MB k=0 gate: {counts.tolist()} != {expected}")
    need(expected[1] >= mb - 2, f"{mb} MB k=0: only {expected[1]} planted copies")
    three, mbps = cold_warm(sc, syn, expected)
    say(f"phase 4 e2e k=0 {mb} MB: gate ok, counts {counts.tolist()}, first call {first_ms:.1f} "
        f"ms; {three} "
        f"({torch.cuda.get_device_name(0) if dev.type == 'cuda' else dev})")
    if not conv:
        return syn, pats, expected
    # apm's XLA correlation conv (plain PyTorch conv1d here): pinned on the
    # reference-shaped set, then auto past the fused kernel (m_max = 120)
    from apm_torch.models.pipeline import make_plan

    cfg = lambda **kw: apm_torch.ApmConfig(device=str(dev), **kw)
    dp_mbps = _timed_counts(apm_torch.Scanner(pats, 0, cfg(engine="dp")), syn)
    scc = apm_torch.Scanner(pats, 0, cfg(corr_impl="conv"))
    got = main.run(f"{mb} MB k=0 corr_impl=conv", [], lambda: scc.count(syn))
    need(got.tolist() == expected, f"{mb} MB k=0 conv: {got.tolist()} != {expected}")
    say(f"phase 4b e2e k=0 {mb} MB corr_impl=conv: gate ok, median {_timed_counts(scc, syn):.1f} "
        f"MB/s conv, {mbps:.1f} MB/s kernel B (auto), {dp_mbps:.1f} MB/s engine=dp (all cold)")
    p120 = syn[4096 : 4096 + 120].tobytes()  # a planted 50-mer and the 70 bytes after it
    pats120 = [p32.tobytes(), p120]
    sc120 = apm_torch.Scanner(pats120, 0, cfg())
    need(sc120._routes(make_plan(sc120, len(syn)))[0] == "conv", "m_max 120: auto does not take the conv")
    got = main.run(f"{mb} MB k=0 m_max=120 auto (conv)", [], lambda: sc120.count(syn))
    bound120 = sc120.device_window_bound(len(syn))
    tail = count_matches(syn[bound120:], pats120, 0)
    syn_b = syn.tobytes()
    want = [host_exact_count(syn_b[: bound120 + len(p) - 1], p) + t for p, t in zip(pats120, tail)]
    del syn_b
    need(got.tolist() == want and want[1] >= 1, f"{mb} MB k=0 m_max=120: {got.tolist()} != {want}")
    dp120 = _timed_counts(apm_torch.Scanner(pats120, 0, cfg(engine="dp")), syn)
    say(f"phase 4b e2e k=0 {mb} MB m_max=120 (auto: the conv): gate ok, counts {got.tolist()}, "
        f"median {_timed_counts(sc120, syn):.1f} MB/s conv, {dp120:.1f} MB/s engine=dp (cold)")
    return syn, pats, expected


def phase_e2e_dp(main, dev, mb: int = 32) -> None:
    import apm_torch
    from apm_torch import ApmConfig
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern
    from apm_torch.utils.oracle import count_matches

    p32, p50 = random_pattern(32, seed=21), random_pattern(50, seed=22)
    pats = [p32.tobytes()] + [p50.tobytes()] * 5
    for kk in (1, 2):
        c = random_corpus(mb << 20, seed=30 + kk)
        plant(c, p50, range(4096, (mb << 20) - 100, 1 << 18), k=kk, seed=40 + kk)
        plant(c, p32, range(70_000, (mb << 20) - 100, 1 << 19), k=kk, seed=50 + kk)
        sc = apm_torch.Scanner(pats, kk, ApmConfig(engine="dp", device=str(dev)))
        counts = main.run(f"{mb} MB k={kk} engine=dp", ["dp_band"], lambda: sc.count(c))
        plain = apm_torch.Scanner(
            pats, kk, ApmConfig(engine="dp", backend="torch", device=str(dev))
        )
        ref = plain.count(c)
        need(counts.tolist() == ref.tolist(),
             f"{mb} MB k={kk}: kernels {counts.tolist()} != plain {ref.tolist()}")
        need(counts[1] >= (mb << 20) // (1 << 18) - 1, f"{mb} MB k={kk}: plants missed")
        prefix = c[: 1 << 20]
        got = sc.count(prefix).tolist()
        want = count_matches(prefix, pats[:2], kk)
        want = [want[0]] + [want[1]] * 5
        need(got == want, f"1 MB k={kk}: {got} != oracle {want}")
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            sc.count(c)
            secs.append(time.perf_counter() - t0)
        mbps = len(c) / statistics.median(secs) / 1e6
        say(f"phase 5 e2e k={kk} engine=dp {mb} MB: kernels == plain, 1 MB prefix == "
            f"oracle, counts {counts.tolist()}, median {mbps:.1f} MB/s over 3 reps")


def _dedup_oracle(prefix, pats, k):
    """Oracle counts of a pattern list, each distinct pattern counted once,
    the patterns on host threads of their own (NumPy releases the GIL in
    its array loops)."""
    from concurrent.futures import ThreadPoolExecutor

    from apm_torch.utils.oracle import count_matches

    uniq = list(dict.fromkeys(pats))
    with ThreadPoolExecutor(len(uniq)) as ex:
        got = dict(zip(uniq, ex.map(lambda p: count_matches(prefix, [p], k)[0], uniq)))
    return [got[p] for p in pats]


def _timed_counts(sc, c, reps: int = 3, want=None, cold: bool = True) -> float:
    """Median MB/s of ``sc.count(c)`` over ``reps`` calls (host clock).
    ``cold``: the Scanner's device cache is emptied before each call, so
    every call hashes, folds and copies. ``want``: each call's counts must
    equal it."""
    secs = []
    for _ in range(reps):
        if cold:
            sc._dev_cache.clear()
        t0 = time.perf_counter()
        got = sc.count(c)
        secs.append(time.perf_counter() - t0)
        need(want is None or got.tolist() == list(want), f"timed count: {got.tolist()} != {want}")
    return len(c) / statistics.median(secs) / 1e6


def frozen_copy(c):
    """A read-only copy of ``c``: the Scanner memoizes its key."""
    f = c.copy()
    f.setflags(write=False)
    return f


def cold_warm(sc, c, want, frozen=None):
    """``sc.count(c)`` three ways, median MB/s of 3 each, every call gated
    by ``want``: cold (cache emptied first), warm on a frozen copy (a hit,
    the key memoized) and warm on the writable ``c`` (the full hash, then a
    hit). A traced warm frozen call must show no ``fold`` and no ``copy``
    span. Returns the line to print and the cold MB/s."""
    frozen = frozen_copy(c) if frozen is None else frozen
    cold = _timed_counts(sc, c, want=want)
    sc.count(frozen)  # stages the rows and memoizes the frozen copy's key
    warm = _timed_counts(sc, frozen, want=want, cold=False)
    hashed = _timed_counts(sc, c, want=want, cold=False)
    sc.meter.trace = True
    try:
        need(sc.count(frozen).tolist() == list(want), "traced warm call: counts differ")
        spans = dict(sc.meter.last_spans)
    finally:
        sc.meter.trace = False
    need(not {"fold", "copy"} & set(spans) and "fingerprint" in spans,
         f"warm frozen call staged rows: spans {spans}")
    return (f"cold {cold:.1f} MB/s, warm frozen {warm:.1f} MB/s, warm writable (hash only) "
            f"{hashed:.1f} MB/s (medians of 3, each gated; warm frozen spans: no fold, no copy, "
            f"fingerprint {spans['fingerprint']:.3f} ms)"), cold


def device_busy(sc, c, cold: bool = False) -> str:
    """Device busy share of one ``sc.count(c)``: the union of the device
    activity intervals ``torch.profiler`` records (kernels, copies,
    memsets), over the call's host-clock time. ``cold``: the device cache
    is emptied first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if cold:
        sc._dev_cache.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sc.count(c)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return "device busy not measured (the profiler saw no device activity)"
    busy, top = 0.0, {}
    (s0, e0), *rest = sorted((e.time_range.start, e.time_range.end) for e in evs)
    for s1, e1 in rest:
        if s1 > e0:
            busy, s0, e0 = busy + e0 - s0, s1, e1
        else:
            e0 = max(e0, e1)
    busy += e0 - s0
    for e in evs:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us()
    names = sorted(top, key=top.get, reverse=True)[:5]
    return (f"device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
            f"({100 * busy / wall_us:.1f} %, idle {100 - 100 * busy / wall_us:.1f} %; "
            f"torch.profiler, one call); top device work: "
            + "; ".join(f"{n[:48]} {top[n] / 1e3:.3f} ms" for n in names))


def breakdown(sc, c, cold: bool) -> str:
    """Where one ``sc.count(c)`` spends its time: the Scanner's own spans
    (``Scanner.meter.trace``; medians of 3 calls), then the device's busy
    share under ``torch.profiler``. ``cold``: the device cache is emptied
    before each call; else ``c`` is a frozen array whose rows are cached."""
    sc.meter.trace = True
    runs, secs = [], []
    try:
        for _ in range(3):
            if cold:
                sc._dev_cache.clear()
            t0 = time.perf_counter()
            sc.count(c)
            secs.append(time.perf_counter() - t0)
            runs.append(sc.meter.last_spans)
    finally:
        sc.meter.trace = False
    if not cold:
        need(not any({"fold", "copy"} & set(r) for r in runs), "warm breakdown: a call staged rows")
    spans = ", ".join(
        f"{name} {statistics.median(r.get(name, 0.0) for r in runs):.3f} ms"
        for name in runs[0]
    )
    return (f"count {statistics.median(secs) * 1e3:.1f} ms with spans on; {spans}; "
            f"{device_busy(sc, c, cold=cold)}")


def phase_e2e_filter(main, dev, mb: int = 256, dense_mb: int = 32, over_step: int = 200 << 10):
    """Scanner.count at k >= 1 under engine="auto" on bench.py's cells,
    each gated by the same scan under engine="dp", dp_impl="band" (kernel
    A over the whole corpus) and by a 1 MB prefix against the oracle.
    Returns the (name, scanner, corpus, frozen copy) of the cells to break
    down, and the cells phase 12 shards: (name, patterns, k, corpus,
    counts, config keywords, the kernels the route launches)."""
    import apm_torch
    from apm_torch import ApmConfig
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern

    size = mb << 20
    base = random_corpus(size, seed=0)
    p32, p50 = random_pattern(32, seed=11), random_pattern(50, seed=12)
    ref_set = [p32.tobytes()] + [p50.tobytes()] * 5
    fifty = [random_pattern(50, seed=200 + i).tobytes() for i in range(6)]
    long2 = [random_pattern(120, seed=210 + i).tobytes() for i in range(2)]
    cfg = lambda **kw: ApmConfig(device=str(dev), **kw)
    # bench.py's plants: one copy per MB, pattern i offset by i * 128 KB
    every_mb = lambda i=0: list(range(5000 + i * 131072, size - 4096, 1 << 20))

    def gate(name, pats, k, c, sc, expect):
        counts = main.run(name, expect, lambda: sc.count(c))
        band = apm_torch.Scanner(pats, k, cfg(engine="dp", dp_impl="band")).count(c)
        need(counts.tolist() == band.tolist(),
             f"{name}: auto {counts.tolist()} != engine=dp band {band.tolist()}")
        return counts

    def cell(name, pats, k, planted, expect, route=None, fused=False, shard=False):
        c = base.copy()
        for i, p in enumerate(planted):
            plant(c, np.frombuffer(p, np.uint8), every_mb(i), k=k, seed=13 + i)
        sc = apm_torch.Scanner(pats, k, cfg())
        counts = gate(name, pats, k, c, sc, expect)
        need(counts[pats.index(planted[0])] >= len(every_mb()), f"{name}: plants missed")
        info = sc.last_filtration or {"route": "banded DP only"}
        need(route in (None, info["route"]), f"{name}: route {info}, expected {route}")
        prefix = c[: 1 << 20]
        got = sc.count(prefix).tolist()
        want = _dedup_oracle(prefix, pats, k)
        need(got == want, f"{name} 1 MB prefix: {got} != oracle {want}")
        frozen = frozen_copy(c)
        three, auto_mbps = cold_warm(sc, c, counts.tolist(), frozen)
        dp_mbps = _timed_counts(apm_torch.Scanner(pats, k, cfg(engine="dp")), c)
        say(f"phase 5b {name} k={k}: auto == dp band, 1 MB prefix == oracle, counts "
            f"{counts.tolist()}, route {info['route']}, n_hot {info.get('n_hot', '-')} "
            f"(bucket {info.get('max_hot', '-')}); auto {three}; engine=dp cold "
            f"{dp_mbps:.1f} MB/s")
        if shard:
            shard_cells.append((name, pats, k, c, counts.tolist(), {}, expect))
        if fused:  # phase 1 through kernel #7, gated by the same counts and prefix
            scf = apm_torch.Scanner(pats, k, cfg(corr_impl="fused"))
            got = main.run(f"{name} corr_impl=fused", ["pieces_fused"] + expect, lambda: scf.count(c))
            need(got.tolist() == counts.tolist(),
                 f"{name} fused: {got.tolist()} != engine=dp band {counts.tolist()}")
            finfo = scf.last_filtration  # of the 256 MB count, not of the prefix
            need(scf.count(prefix).tolist() == want, f"{name} fused 1 MB prefix != oracle {want}")
            say(f"phase 5c {name} k={k} corr_impl=fused: == dp band, 1 MB prefix == oracle, route "
                f"{finfo['route']}, n_hot {finfo.get('n_hot', '-')}, median (cold) "
                f"{_timed_counts(scf, c):.1f} MB/s fused, {auto_mbps:.1f} MB/s auto (piece conv), "
                f"{dp_mbps:.1f} MB/s engine=dp")
            if shard:
                shard_cells.append((f"{name} corr_impl=fused", pats, k, c, counts.tolist(),
                                    {"corr_impl": "fused"}, ["pieces_fused"] + expect))
        return sc, c, frozen

    # The kernels each route must launch: kernel A verifies at k <= 2 and
    # kernel C at k >= 3 (Myers mode under auto); kernel D is phase 1
    # where the piece conv is not.
    keep, shard_cells = [], []
    for k in (1, 2):
        cell(f"{mb}mb_k{k}_planted", ref_set, k, [ref_set[1]], ["dp_band"], "device-verify",
             fused=True, shard=k == 1)
    keep.append((f"{mb}mb_k3_planted",) + cell(
        f"{mb}mb_k3_planted", ref_set, 3, [ref_set[1]], ["filter_pieces", "dp_myers"], shard=True))
    cell(f"{mb}mb_k4_exact_tier", fifty, 4, fifty, ["dp_myers"])
    keep.append((f"{mb}mb_k8_banded_tier",) + cell(
        f"{mb}mb_k8_banded_tier", long2, 8, long2, ["filter_pieces", "dp_myers"], shard=True))
    cell(f"{mb}mb_k12_myers_dp", fifty, 12, fifty, ["dp_myers"])

    # k = 0 on a short set: kernel D's candidates are the exact counts
    short = [random_pattern(12, seed=220).tobytes(), random_pattern(20, seed=221).tobytes()]
    c = base.copy()
    plant(c, np.frombuffer(short[1], np.uint8), every_mb(), k=0)
    sc = apm_torch.Scanner(short, 0, cfg())
    counts = main.run(f"{mb}mb_k0_short_set", ["filter_pieces"], lambda: sc.count(c))
    bound = sc.device_window_bound(len(c))
    tail = _dedup_oracle(c[bound:], short, 0)
    cb = c.tobytes()
    want = [host_exact_count(cb[: bound + len(p) - 1], p) + t for p, t in zip(short, tail)]
    del cb
    need(counts.tolist() == want, f"k=0 short set: {counts.tolist()} != {want}")
    need(counts[1] >= len(every_mb()), "k=0 short set: plants missed")
    say(f"phase 5b {mb}mb_k0_short_set (m 12, 20; kernel D): host count + oracle tail ok, "
        f"counts {counts.tolist()}; {cold_warm(sc, c, want)[0]}")
    del c

    # Dense: a candidate in every row takes the density rescan
    dense = base[: dense_mb << 20].copy()
    plant(dense, p50, range(1000, len(dense) - 100, 4096), k=1, seed=230)
    sc = apm_torch.Scanner(ref_set, 1, cfg())
    counts = gate("dense", ref_set, 1, dense, sc, ["dp_band"])
    info = sc.last_filtration
    need(info["route"] == "rescan", f"dense: route {info}")
    say(f"phase 5b dense {dense_mb} MB k=1 (a plant every 4 KB): auto == dp band, counts "
        f"{counts.tolist()}, route {info['route']}, n_hot {info['n_hot']}; "
        f"{cold_warm(sc, dense, counts.tolist())[0]}")
    shard_cells.append((f"dense {dense_mb} MB", ref_set, 1, dense, counts.tolist(), {}, ["dp_band"]))
    del dense

    # Overflow: more hot rows than the bucket, fewer than the density
    # threshold, so count_hot_batch re-verifies on the device
    over = base.copy()
    plant(over, p50, range(1000, len(over) - 100, over_step), k=1, seed=240)
    sc = apm_torch.Scanner(ref_set, 1, cfg())
    counts = gate("overflow", ref_set, 1, over, sc, ["dp_band"])
    info = sc.last_filtration
    need(info["route"] == "count_hot_batch", f"overflow: route {info}")
    say(f"phase 5b overflow {mb} MB k=1 (a plant every {over_step >> 10} KB): auto == dp "
        f"band, counts {counts.tolist()}, route {info['route']}, n_hot {info['n_hot']} > "
        f"bucket {info['max_hot']}; {cold_warm(sc, over, counts.tolist())[0]}")
    shard_cells.append((f"overflow {mb} MB", ref_set, 1, over, counts.tolist(), {}, ["dp_band"]))
    return keep, shard_cells


def phase_entry(main, rec, dev) -> None:
    """``apm_torch.graft_entry.entry()`` on the card: ``fn(*args)`` runs
    kernel #9 on the example's staging; it must equal the plain version on
    the same arguments and the oracle over the device-owned windows (the
    window set of ``apm``'s TPU branch)."""
    import torch

    from apm_torch import graft_entry
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.oracle import banded_distances

    fn, args = graft_entry.entry()
    need(all(a.device == dev for a in args), "entry(): arguments not on the card")
    got = main.run("entry()", ["dp_dyn"], lambda: fn(*args))
    k, m_max = graft_entry.K, graft_entry.example_tables()[2]
    kw = dict(k=k, m_max=m_max, wf=graft_entry.W // dp_kernel.FOLD, halo=round_up(m_max, 128))
    plain = dp_kernel.scan_folded_ref(*args, **kw)
    torch.cuda.synchronize()
    rec.compare(got, plain, "entry()")
    corpus, bound = graft_entry.example_corpus(), int(args[3])
    owned = [int((banded_distances(corpus, p, k)[:bound] <= k).sum()) for p in graft_entry.PATTERNS]
    need(got.tolist()[:2] == owned and sum(owned) > 0, f"entry(): {got.tolist()} != oracle {owned}")
    need(got.tolist()[2:] == [0] * 6, "entry(): a padding row counted")
    ms = cuda_ms(lambda: fn(*args), 5)
    say(f"phase 10 entry(): fn(*args) on the card == plain == oracle over the {bound} device-owned "
        f"windows, counts {got.tolist()[:2]}, {ms:.3f} ms a call")


def host_ms(fn, reps: int = 3) -> float:
    """Median milliseconds of ``fn`` on the host clock (one warm-up)."""
    fn()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs) * 1e3


def phase_host(dev, n_rows: int = 32768) -> None:
    """Phase 1's host layer on this machine's CPU: the native fold of a
    256 MB chunk (the main path's 32768 rows of 8192 + 128 bytes) into
    page-locked rows beside ``fold_corpus_ref`` into the same kind of rows
    (equal bytes), ``hash_bytes`` of the chunk, and the EOF tails of phase
    5b's k = 3 and k = 8 cells through ``Scanner.tail_counts`` (native)
    beside the NumPy oracle on the same suffix (equal counts)."""
    import torch

    import apm_torch
    from apm_torch.ops.common import fold_corpus, fold_corpus_ref
    from apm_torch.utils import native
    from apm_torch.utils.corpus import random_corpus, random_pattern
    from apm_torch.utils.oracle import count_matches

    wf, halo = 8192, 128
    c = np.frombuffer(np.random.default_rng(5).bytes(n_rows * wf), np.uint8)
    pin = dev.type == "cuda"
    pinned = lambda: torch.empty((n_rows, wf + halo), dtype=torch.uint8, pin_memory=pin).numpy()
    rows, ref = pinned(), pinned()
    nat_ms = host_ms(lambda: fold_corpus(c, 0, n_rows, wf, halo, out=rows))
    ref_ms = host_ms(lambda: fold_corpus_ref(c, 0, n_rows, wf, halo, out=ref))
    need(np.array_equal(rows, ref), "phase 1: native fold != fold_corpus_ref")
    hash_ms = host_ms(lambda: native.hash_bytes(c))
    del rows, ref
    say(f"phase 1 host layer, {os.cpu_count()} CPUs: fold of a {len(c) >> 20} MB chunk into page-locked "
        f"rows native {nat_ms:.1f} ms ({len(c) / nat_ms / 1e6:.2f} GB/s), fold_corpus_ref "
        f"{ref_ms:.1f} ms ({len(c) / ref_ms / 1e6:.2f} GB/s; equal rows); "
        f"hash_bytes {hash_ms:.1f} ms ({len(c) / hash_ms / 1e6:.2f} GB/s, "
        f"{min(16, os.cpu_count() or 1)} threads)")
    p32, p50 = random_pattern(32, seed=11).tobytes(), random_pattern(50, seed=12).tobytes()
    long2 = [random_pattern(120, seed=210 + i).tobytes() for i in range(2)]
    for name, pats, k in (("k3_planted", [p32] + [p50] * 5, 3), ("k8_banded_tier", long2, 8)):
        buf = random_corpus(1 << 20, seed=6)
        buf[-40:] = np.frombuffer(pats[-1][:40], np.uint8)  # an EOF-truncated match
        sc = apm_torch.Scanner(pats, k, apm_torch.ApmConfig(device=str(dev)))
        bound = sc.device_window_bound(len(buf))
        uniq = list(sc.scan_patterns.raw)
        got = sc.tail_counts(buf, bound)
        want = count_matches(buf[bound:], uniq, k)
        need(got.tolist() == want and sum(want) > 0, f"phase 1 {name} tail: {got.tolist()} != {want}")
        nat = host_ms(lambda: sc.tail_counts(buf, bound))
        ora = host_ms(lambda: count_matches(buf[bound:], uniq, k))
        say(f"phase 1 EOF tail of {name} ({len(uniq)} distinct patterns, m_max {sc.m_max}, "
            f"{len(buf) - bound} bytes): native {nat:.3f} ms, NumPy oracle {ora:.3f} ms "
            f"({ora / nat:.1f}x), counts equal {got.tolist()}")


def phase_serving(main, dev, syn, pats, want, piece: int = 16 << 20, segment: int = 64 << 20,
                  chunk: int = 128 << 20) -> None:
    """Phase 11: ``count_file``, ``count_stream``, ``warmup``, prewarm and
    an eviction on phase 4's 256 MB k = 0 cell, each gated by its counts
    ``want``."""
    import apm_torch

    cfg = lambda **kw: apm_torch.ApmConfig(device=str(dev), **kw)
    mb = len(syn) >> 20

    def timed(what, expect, fn):
        t0 = time.perf_counter()
        got = main.run(what, expect, fn)
        ms = (time.perf_counter() - t0) * 1e3
        need(got.tolist() == want, f"{what}: {got.tolist()} != {want}")
        return ms

    fd, path = tempfile.mkstemp(suffix=".fa")
    try:
        with os.fdopen(fd, "wb") as f:
            syn.tofile(f)
        sc = apm_torch.Scanner(pats, 0, cfg())
        first = timed(f"count_file {mb} MB k=0", ["corr_fused"], lambda: sc.count_file(path))
        again = host_ms(lambda: need(sc.count_file(path).tolist() == want, "count_file repeat"))
        say(f"phase 11 count_file {mb} MB k=0 (a read-only memmap): == count, first call "
            f"{first:.1f} ms, repeat (a new mapping: hash, then a hit) {again:.1f} ms")
    finally:
        os.unlink(path)

    pieces = lambda: (syn[i : i + piece].tobytes() for i in range(0, len(syn), piece))
    ms = timed(f"count_stream {mb} MB in {piece >> 20} MB pieces", ["corr_fused"],
               lambda: sc.count_stream(pieces(), segment_bytes=segment))
    need(not sc._stream_scanner._dev_cache, "count_stream: a segment entered a cache")
    say(f"phase 11 count_stream {mb} MB in {piece >> 20} MB pieces, {segment >> 20} MB segments: "
        f"== count, {ms:.1f} ms "
        f"({len(syn) / ms / 1e3:.1f} MB/s, the pieces' bytes copies included)")

    cold_sc = apm_torch.Scanner(pats, 0, cfg())
    t0 = time.perf_counter()
    need(cold_sc.count(syn).tolist() == want, "first count without warmup")
    no_warm = (time.perf_counter() - t0) * 1e3
    del cold_sc
    sw = apm_torch.Scanner(pats, 0, cfg())
    t0 = time.perf_counter()
    sw.warmup(len(syn))
    warm_s = time.perf_counter() - t0
    need(sw._dev_cache == {}, "warmup left zero-corpus rows in the cache")
    first = timed(f"count {mb} MB k=0 after warmup", ["corr_fused"], lambda: sw.count(syn))
    say(f"phase 11 warmup({mb} MB): {warm_s:.2f} s (count, find and count_batch on zeros); "
        f"the first count after it {first:.1f} ms, a first count without warmup {no_warm:.1f} ms")

    t0 = time.perf_counter()
    sp = apm_torch.Scanner(pats, 0, cfg(prewarm_bytes=len(syn)))
    need(sp.prewarm_join(timeout=600), "prewarm_join: the prewarm did not finish")
    joined = time.perf_counter() - t0
    first = timed(f"count {mb} MB k=0 after prewarm_join", ["corr_fused"], lambda: sp.count(syn))
    say(f"phase 11 prewarm_bytes={mb} MB: constructor + prewarm_join {joined:.2f} s, then the "
        f"first count {first:.1f} ms, == count")

    probe = apm_torch.Scanner(pats, 0, cfg(chunk_bytes=chunk))
    need(probe.count(syn).tolist() == want, "two chunks: counts differ")
    sizes = [v.numel() for v in probe._dev_cache.values()]
    need(len(sizes) == 2 and sizes[0] == sizes[1], f"two chunks: cache entries {sizes}")
    one = sizes[0]
    del probe
    se = apm_torch.Scanner(pats, 0, cfg(chunk_bytes=chunk, cache_bytes=one))
    first = timed(f"count {mb} MB k=0, cache_bytes of one chunk", ["corr_fused"],
                  lambda: se.count(syn))
    for rep in range(2):
        need(len(se._dev_cache) == 1 and next(iter(se._dev_cache.values())).numel() == one,
             f"eviction: cache holds {[v.numel() for v in se._dev_cache.values()]}, budget {one}")
        need(se.count(syn).tolist() == want, f"eviction: repeat {rep} counts differ")
    say(f"phase 11 eviction: {chunk >> 20} MB chunks, cache_bytes {one} (one chunk): each count keeps one "
        f"chunk, evicting the other; == count ({first:.1f} ms the first call)")


SHARDING_LABEL = "shards on one card: sharding cost, not scaling"


def _expand(sc, counts):
    """A distributed scan's per-slot counts as ``count`` returns them."""
    return counts[: sc.scan_patterns.num_patterns][sc._inverse].tolist()


def _cold_ms(sc, fn, reps: int = 3) -> float:
    """Median host milliseconds of ``fn()`` with ``sc``'s device caches
    emptied first (every call hashes, folds and copies)."""
    secs = []
    for _ in range(reps):
        sc._dev_cache.clear()
        for rep in sc._replica_scanners.values():
            rep._dev_cache.clear()
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs) * 1e3


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multihost_worker(argv) -> int:
    """``chip_smoke.py --multihost-worker DEVICE PORT RANK WORLD OUT K|PATH|PATTERN,...``:
    one process of phase 12d's two-process ``gloo`` group, on ``DEVICE``
    (card 0 in phase 12; the CPU in a rehearsal). For
    each cell, ``count_multihost`` of the file ``PATH`` at ``K``, the launch
    counters set to 0 just before and read just after; the counts of the
    distinct patterns and the launches go to the JSON file ``OUT``."""
    import torch

    device, port, rank, world, out, *cells = argv
    if device.startswith("cuda") and not torch.cuda.is_available():
        say("no CUDA device visible to torch")
        return 1
    import apm_torch
    from apm_torch.parallel import multihost

    main = MainPath()
    multihost.initialize(f"localhost:{port}", int(world), int(rank), backend="gloo", timeout=600)
    results = []
    try:
        for cell in cells:
            k, path, pats = cell.split("|")
            pats = [p.encode() for p in pats.split(",")]
            sc = apm_torch.Scanner(pats, int(k), apm_torch.ApmConfig(device=device))
            main.reset()
            t0 = time.perf_counter()
            counts = multihost.count_multihost(sc, path)
            first = (time.perf_counter() - t0) * 1e3
            launches = main.read()
            t0 = time.perf_counter()
            again = multihost.count_multihost(sc, path)
            ms = (time.perf_counter() - t0) * 1e3
            results.append({"k": int(k), "counts": _expand(sc, counts), "again": _expand(sc, again),
                            "launches": launches, "first_ms": first, "ms": ms,
                            "route": (sc.last_filtration or {}).get("route")})
    finally:
        multihost.shutdown()
    with open(out, "w") as f:
        json.dump({"rank": int(rank), "cells": results}, f)
    return 0


def phase_distribution(main, dev, k0_cell, shard_cells) -> None:
    """Phase 12: the sharded scans on the card, each call gated by the
    single-device counts phases 4 and 5b gated. (a) database_over_devices
    on 2 and 4 shards of card 0 over phase 4's k = 0 cell and phase 5b's
    shard cells; (b) patterns_over_devices on 2 shards over the 6-pattern
    k = 3 cell; (c) Scanner.count under strategy="database_over_devices" on
    the visible cards; (d) count_multihost of phase 4's k = 0 and phase
    5b's k = 3 cell, each written to a file, in a 1-process nccl world and
    in 2 processes under gloo, both on card 0; (e) dryrun_multichip on 4 shards of card 0. The first call of
    (a), (b) and (d) in each case is on the main path; the times of (a)
    and (b) are medians of 3 cold calls (device caches emptied), those of
    (d) a second call (count_multihost stages from the file every call)."""
    import apm_torch
    from apm_torch.graft_entry import dryrun_multichip
    from apm_torch.parallel import count_distributed, multihost

    t_phase = time.perf_counter()
    cfg = lambda **kw: apm_torch.ApmConfig(device=str(dev), **kw)
    syn, pats0, want0 = k0_cell
    cells = [(f"{len(syn) >> 20} MB k=0", pats0, 0, syn, want0, {}, ["corr_fused"])] + shard_cells
    for name, pats, k, c, want, kw, expect in cells:
        sc = apm_torch.Scanner(pats, k, cfg(**kw))
        single_ms = _cold_ms(sc, lambda: need(sc.count(c).tolist() == want, f"12a {name}: single"))
        parts = []
        for n_sh in (2, 4):
            shards = [dev] * n_sh
            run = lambda: count_distributed(sc, c, "database_over_devices", shards)
            got = main.run(f"12a {name} database_over_devices x{n_sh}", expect, run)
            need(_expand(sc, got) == want, f"12a {name} x{n_sh}: {_expand(sc, got)} != {want}")
            route = (sc.last_filtration or {}).get("route", "no filtration")
            ms = _cold_ms(sc, lambda: need(_expand(sc, run()) == want, f"12a {name} x{n_sh}: repeat"))
            parts.append(f"x{n_sh} {ms:.1f} ms (route {route})")
        say(f"phase 12a {name}, database_over_devices ({SHARDING_LABEL}): == single-device counts "
            f"{want}; single device {single_ms:.1f} ms; " + "; ".join(parts))

    name, pats, k, c, want, _, _ = next(x for x in shard_cells if x[2] == 3)
    sc = apm_torch.Scanner(pats, k, cfg())
    single_ms = _cold_ms(sc, lambda: sc.count(c))
    run = lambda: count_distributed(sc, c, "patterns_over_devices", [dev, dev])
    got = main.run(f"12b {name} patterns_over_devices x2", ["dp_myers"], run)
    need(_expand(sc, got) == want, f"12b {name}: {_expand(sc, got)} != {want}")
    routes = [(sub.last_filtration or {}).get("route", "no filtration") for sub in sc._shard_scanners]
    for sub in sc._shard_scanners:
        sub._dev_cache.clear()
    ms = _cold_ms(sc, lambda: need(_expand(sc, run()) == want, "12b: repeat"))
    say(f"phase 12b {name}, patterns_over_devices x2 ({SHARDING_LABEL}): == single-device counts, "
        f"{len(sc._shard_scanners)} groups, routes {routes}; single device {single_ms:.1f} ms, "
        f"x2 {ms:.1f} ms (one thread a group, one host fold)")

    sc = apm_torch.Scanner(pats0, 0, cfg(strategy="database_over_devices"))
    need(sc.count(syn).tolist() == want0, "12c: counts differ")
    say(f"phase 12c Scanner.count strategy=database_over_devices on the visible cards: n_dev "
        f"{len(sc.devices())}, last_strategy {sc.last_strategy}, == phase 4's counts")

    # (d): phase 4's k = 0 cell and phase 5b's k = 3 cell, each as a file
    k3 = next(x for x in shard_cells if x[2] == 3)
    mh_cells = [(0, syn, pats0, want0, ["corr_fused"]), (3, k3[3], k3[1], k3[4], k3[6])]
    paths = []
    try:
        for _, c, _, _, _ in mh_cells:
            fd, path = tempfile.mkstemp(suffix=".fa")
            paths.append(path)
            with os.fdopen(fd, "wb") as f:
                c.tofile(f)
        backend = "nccl" if dev.type == "cuda" else "gloo"  # gloo: a CPU rehearsal
        multihost.initialize(f"localhost:{_free_port()}", 1, 0, backend=backend, timeout=600)
        try:
            for (k, c, pats, want, expect), path in zip(mh_cells, paths):
                sc = apm_torch.Scanner(pats, k, cfg())
                t0 = time.perf_counter()
                got = main.run(f"12d count_multihost {len(c) >> 20} MB file k={k}, 1 process ({backend})",
                               expect, lambda: multihost.count_multihost(sc, path))
                first = (time.perf_counter() - t0) * 1e3
                need(_expand(sc, got) == want, f"12d nccl k={k}: {_expand(sc, got)} != {want}")
                route = (sc.last_filtration or {}).get("route", "no filtration")
                t0 = time.perf_counter()
                need(_expand(sc, multihost.count_multihost(sc, path)) == want, f"12d {backend} k={k}: again")
                ms = (time.perf_counter() - t0) * 1e3
                single_ms = _cold_ms(sc, lambda: sc.count(c))
                say(f"phase 12d count_multihost {len(c) >> 20} MB file k={k}, a 1-process {backend} "
                    f"world: == single-device counts {want}, route {route}; {ms:.1f} ms a call "
                    f"(the first {first:.1f} ms); single-device count cold {single_ms:.1f} ms")
        finally:
            multihost.shutdown()
        port = _free_port()
        outs = [os.path.join(tempfile.gettempdir(), f"apm_smoke_mh{os.getpid()}_{i}.json") for i in range(2)]
        args = [f"{k}|{path}|" + ",".join(dict.fromkeys(p.decode() for p in pats))
                for (k, _, pats, _, _), path in zip(mh_cells, paths)]
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--multihost-worker", str(dev),
                 str(port), str(i), "2", outs[i], *args],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for i in range(2)
        ]
        t0 = time.perf_counter()
        try:
            for i, p in enumerate(procs):
                out, err = p.communicate(timeout=300)
                need(p.returncode == 0, f"12d worker {i} exit {p.returncode}: {(out + err)[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        results = []
        for o in outs:
            with open(o) as f:
                results.append(json.load(f))
            os.unlink(o)
    finally:
        for path in paths:
            os.unlink(path)
    for res in results:
        for cell, (k, _, pats, want, expect) in zip(res["cells"], mh_cells):
            # a worker counts the distinct patterns; expand as count() does
            inverse = apm_torch.Scanner(pats, k, cfg())._inverse
            for key in ("counts", "again"):
                got = [cell[key][i] for i in inverse]
                need(got == want, f"12d gloo rank {res['rank']} k={k} ({key}): {got} != {want}")
            main.record(f"12d count_multihost k={k}, 2 processes (gloo), rank {res['rank']}",
                        expect, cell["launches"])
    say(f"phase 12d count_multihost, 2 processes under gloo on card 0 ({SHARDING_LABEL}): every "
        f"rank == single-device counts at k=0 and k=3; "
        + "; ".join(f"rank {r['rank']}: " + ", ".join(
            f"k={c['k']} {c['ms']:.1f} ms a call, the first {c['first_ms']:.1f} ms (route "
            f"{c['route'] or 'no filtration'})" for c in r["cells"])
            for r in results)
        + f"; {wall:.1f} s for both processes, start-up and kernel loading included")

    t0 = time.perf_counter()
    dryrun_multichip([dev] * 4)
    say(f"phase 12e dryrun_multichip on 4 shards of card 0: every case == oracle, "
        f"{time.perf_counter() - t0:.1f} s; phase 12 in all {time.perf_counter() - t_phase:.1f} s")


def phase_fuzz(dev, trials: int = 36, max_bytes: int = 512 << 10) -> None:
    """Phase 13: ``run_fuzz`` on the card (seed 0), the oracle on every host
    core while the card works."""
    from apm_torch.utils.fuzz import run_fuzz

    res = run_fuzz(trials, 0, str(dev), max_bytes, workers=os.cpu_count() or 1)
    need(res.mismatch is None, f"phase 13 fuzz: {res.mismatch}")
    need(res.passed == trials, f"phase 13 fuzz: {res.passed} of {trials} trials")
    say(f"phase 13 fuzz: {res.passed} of {trials} trials passed (seed 0, corpora of 64 KB to "
        f"{max_bytes >> 10} KB), checks {res.checks}, {res.seconds:.1f} s")


def phase_cli(device: str = "cuda") -> None:
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern
    from apm_torch.utils.oracle import banded_distances, count_matches

    c = random_corpus(200_000, seed=60)
    p1, p2 = random_pattern(40, seed=61), random_pattern(12, seed=62)
    plant(c, p1, [500, 90_000, 199_980], k=1, seed=63)
    plant(c, p2, [1234, 150_000], k=0)
    pats = [p1.tobytes().decode(), p2.tobytes().decode()]
    fd, path = tempfile.mkstemp(suffix=".fa")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(c.tobytes())
        runs = [
            subprocess.run(
                [sys.executable, "-m", "apm_torch", "1", path, *pats, "--device", device, *extra],
                capture_output=True, text=True, cwd=REPO, timeout=600,
            )
            for extra in ((), ("--positions",))
        ]
    finally:
        os.unlink(path)
    counts = count_matches(c, [p.encode() for p in pats], 1)
    want = [
        f"Approximate Pattern Mathing: looking for 2 pattern(s) in file {path} w/ distance of 1"
    ] + [f"Number of matches for pattern <{p}>: {n}" for p, n in zip(pats, counts)]
    hits = [np.nonzero(banded_distances(c, p.encode(), 1) <= 1)[0] for p in pats]
    with_pos = want + [
        f"Match positions for pattern <{p}>:" + "".join(f" {int(j)}" for j in h)
        for p, h in zip(pats, hits)
    ]
    for r, lines, phase in ((runs[0], want, "6"), (runs[1], with_pos, "9")):
        need(r.returncode == 0, f"CLI exit {r.returncode}: {r.stderr[-2000:]}")
        got = [l for l in r.stdout.splitlines() if not l.startswith("APM done in ")]
        need(got == lines, f"CLI output {got} != {lines}")
    say(f"phase 6 CLI: output lines equal the oracle's, counts {counts}")
    say(f"phase 9 CLI --positions: output lines equal the oracle's, "
        f"{[len(h) for h in hits]} positions")


def run(t_start: float) -> dict:
    import torch

    if not torch.cuda.is_available():
        say("no CUDA device visible to torch; chip_smoke needs one GPU")
        raise SystemExit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)

    from apm_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.host_library()
    host_s = time.perf_counter() - t0
    regs = [l.strip() for l in _build.build_log().splitlines() if "registers" in l]
    say(f"phase 1 environment: torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}; "
        f"kernels built/loaded in {build_s:.1f} s, host library (g++) in {host_s:.1f} s; "
        f"ptxas: {' | '.join(regs)}")
    for kernel in ("dp_band_kernelILi1EE", "dp_myers_kernel"):
        say(f"phase 1 SASS inner loops of {kernel}: {sass_loops(str(_build.build()), kernel)}")
    # kernel #6: the band's DPX body at k = 1 (text staged), and the Myers body
    for kernel in ("band_mask_kernelILi1ELb1E", "myers_mask_kernel"):
        say(f"phase 1 SASS inner loops of {kernel}: {sass_loops(str(_build.build()), kernel, ops=True)}")
        say(f"phase 1 ptxas of {kernel}: {ptxas_of(_build.build_log(), kernel)}")
    # the exact-scan kernels (B, #7, #8) and kernel D
    for kernel in ("corr_count_kernel", "pieces_fused_kernel", "corr_batch_kernel", "filter_pieces_kernel"):
        say(f"phase 1 SASS loops of {kernel} (each without the loops inside it): "
            f"{sass_loops(str(_build.build()), kernel, nested=True)}")
        say(f"phase 1 ptxas of {kernel}: {ptxas_of(_build.build_log(), kernel)}")
    dev = torch.device("cuda", 0)
    phase_host(dev)

    recs = {
        "dp_band": KernelRecord("dp_band", "apm_torch/csrc/dp_band.cu",
                                "apm/ops/pallas_kernel.py:593"),
        "corr_fused": KernelRecord("corr_fused", "apm_torch/csrc/corr_fused.cu",
                                   "apm/ops/corr_fused.py:298"),
        "dp_myers": KernelRecord("dp_myers", "apm_torch/csrc/dp_myers.cu",
                                 "apm/ops/pallas_kernel.py:593"),
        "filter_pieces": KernelRecord("filter_pieces", "apm_torch/csrc/filter_pieces.cu",
                                      "apm/ops/filter_kernel.py:350"),
        "dp_batch": KernelRecord("dp_batch", "apm_torch/csrc/dp_band.cu",
                                 "apm/ops/pallas_kernel.py:691"),
        "dp_mask": KernelRecord("dp_mask", "apm_torch/csrc/dp_mask.cu",
                                "apm/ops/pallas_kernel.py:799"),
        "corr_batch": KernelRecord("corr_batch", "apm_torch/csrc/corr_fused.cu",
                                   "apm/ops/corr_fused.py:764"),
        "pieces_fused": KernelRecord("pieces_fused", "apm_torch/csrc/corr_pieces.cu",
                                     "apm/ops/corr_fused.py:555"),
        "dp_dyn": KernelRecord("dp_dyn", "apm_torch/csrc/dp_band.cu",
                               "apm/ops/pallas_kernel.py:898"),
    }
    phase_dp(recs["dp_band"], dev)
    phase_myers(recs["dp_myers"], dev)
    phase_batch_dp(recs["dp_batch"], dev)
    phase_mask(recs["dp_mask"], dev)
    phase_corr(recs["corr_fused"], dev)
    phase_corr_batch(recs["corr_batch"], dev)
    phase_filter(recs["filter_pieces"], dev)
    phase_dyn(recs["dp_dyn"], dev)
    phase_pieces(recs["pieces_fused"], dev)

    main = MainPath()
    k0_cell = phase_e2e_k0(main, dev, 256, conv=True)
    phase_e2e_k0(main, dev, 512)  # two chunks
    phase_e2e_dp(main, dev)
    keep, shard_cells = phase_e2e_filter(main, dev)
    phase_e2e_batch(main, dev)
    phase_e2e_find(main, dev)
    phase_entry(main, recs["dp_dyn"], dev)
    phase_serving(main, dev, *k0_cell)
    phase_distribution(main, dev, k0_cell, shard_cells)
    del k0_cell, shard_cells
    launches = main.total
    need(all(v > 0 for v in launches.values()), f"a kernel never launched on the main path: {launches}")
    say(f"main path launches, all paths: {launches}")
    for name, sc, c, frozen in keep:
        say(f"phase 5b breakdown {name} cold (first 256 MB chunk): {breakdown(sc, c, cold=True)}")
        say(f"phase 5b breakdown {name} warm (frozen, cache hit): {breakdown(sc, frozen, cold=False)}")
    del keep
    phase_cli()
    phase_fuzz(dev)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [r.json(launches[name]) for name, r in recs.items()]}))
    return {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }


def main() -> int:
    if sys.argv[1:2] == ["--multihost-worker"]:
        return multihost_worker(sys.argv[2:])
    try:
        result = run(time.perf_counter())
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
