#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apm_torch``) once on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. environment: card name and power limit (``nvidia-smi``), torch/CUDA
   versions, and the build of every kernel from ``apm_torch/csrc``;
2. kernel A (banded DP, ``csrc/dp_band.cu``) against its plain PyTorch
   version on the card at main-path shapes (8192-window rows, 128-byte
   halo, 4096 rows = 32 MB), k in {0, 1, 2, 3}, a mixed-length set with a
   mid-row bound, and a band wider than the register path (k = 17);
3. kernel B (fused k = 0 correlation, ``csrc/corr_fused.cu``) against its
   plain version (the TPU's bit-plane matmul formulation) at P = 2, P = 64
   (int8 tables) and m = 80 (32-phase tables), and at P = 2 on the 32768
   rows of a 256 MB main-path chunk;
4. end to end, k = 0, 256 MB (one chunk) and 512 MB (two chunks):
   ``Scanner.count`` on the reference-shaped pattern set (1 x 32 + 5 x 50
   bytes, seeded), gated by a host substring count plus the oracle on the
   EOF tail; MB/s includes the host fold and the host-to-device copy;
5. end to end, k = 1 and k = 2, ``engine="dp"``, 32 MB with planted
   approximate copies: the kernels against the plain versions over the same
   plan on the card, and a 1 MB prefix against the NumPy oracle;
6. the CLI (``python -m apm_torch``) against lines built from the oracle.

Kernel launch counters are reset just before phase 4 and read after phase
5 (the main path); the line before the last is a JSON object with each
kernel's launches, largest disagreement, and time beside its plain
version's; the last line is the device record.
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


class KernelRecord:
    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.max_abs_err = 0
        self.ms = None
        self.plain_ms = None

    def compare(self, got, ref, what):
        import torch

        need(got.shape == ref.shape, f"{self.name} {what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max().item())
        self.max_abs_err = max(self.max_abs_err, err)
        need(err == 0, f"{self.name} {what}: kernel {got.tolist()} != plain {ref.tolist()}")

    def json(self, launches):
        return {
            "name": self.name, "route": "cuda", "source": self.source,
            "replaces": self.replaces, "launches": launches,
            "max_abs_err": self.max_abs_err, "ms": self.ms,
            "plain_ms": self.plain_ms,
        }


def staged(corpus, start_row, n_rows, wf, halo, dev):
    import torch

    from apm_torch.ops.common import fold_corpus

    rows = fold_corpus(corpus, start_row * wf, n_rows, wf, halo)
    return torch.from_numpy(rows).to(dev)


def phase_dp(rec, dev, n_rows: int = 4096) -> None:
    """Kernel A against scan_folded_dp_ref at main-path shapes."""
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import round_up
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern
    from apm_torch.utils.io import PatternSet

    import torch

    wf = 8192
    p32, p50 = random_pattern(32, seed=1), random_pattern(50, seed=2)
    corpus = random_corpus(n_rows * wf + 4096, seed=3)
    pos = list(range(1000, len(corpus) - 200, 65_537))
    plant(corpus, p50, pos, k=1, seed=4)
    plant(corpus, p32, [p + 90 for p in pos], k=0)

    def case(pats, k, n, start_row, bound, what, reps=5, plain_reps=2):
        ps = PatternSet.from_patterns(pats)
        packed, _ = ps.packed(k)
        p_pad = max(8, round_up(len(pats), 8))
        pat = np.zeros((p_pad, packed.shape[1]), np.uint8)
        pat[: len(pats)] = packed
        plens = tuple(int(len(p)) for p in pats) + (0,) * (p_pad - len(pats))
        m_max = ps.max_len
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
        return ms, plain

    pair = [p32.tobytes(), p50.tobytes()]
    full = n_rows * wf - 50 + 1
    for k in (0, 1, 2, 3):
        ms, plain = case(pair, k, n_rows, 0, full, f"P=2 m=32,50 k={k} R={n_rows}")
        if k == 1:
            rec.ms, rec.plain_ms = ms, plain  # phase 5's main-path shape
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

    def case(pats, what, rows=rows, reps=5, plain_reps=2):
        n_rows = rows.shape[0]
        m_max = max(len(p) for p in pats)
        pat_raw = np.zeros((len(pats), m_max), np.uint8)
        for i, p in enumerate(pats):
            pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
        alph = build_alphabet(pats)
        km, thr = corr_fused.build_fused_tables(pat_raw, [len(p) for p in pats], alph)
        tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, corr_fused.pick_s(m_max), dev)
        bound = n_rows * wf - m_max + 1 - 333
        kw = dict(wf=wf, halo=halo, n_rows=n_rows, p_out=8)
        got = corr_fused.scan_corr_fused(rows, tabs, bound, 0, **kw)
        ref = corr_fused.scan_corr_fused_ref(rows, tabs, bound, 0, **kw)
        torch.cuda.synchronize()
        rec.compare(got, ref, what)
        need(int(got.sum()) >= len(pats), f"kernel B {what}: planted copies not found")
        ms = cuda_ms(lambda: corr_fused.scan_corr_fused(rows, tabs, bound, 0, **kw), reps)
        plain = cuda_ms(lambda: corr_fused.scan_corr_fused_ref(rows, tabs, bound, 0, **kw), plain_reps)
        say(f"phase 3 kernel B {what} R={n_rows} ({km.dtype} tables, s_ph={tabs.s_ph}): equal, "
            f"total {int(got.sum())}, kernel {ms:.3f} ms, plain {plain:.3f} ms")
        return ms, plain

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
    planted(pair + wide + mid)
    case(pair, "P=2 m=32,50")
    rec.ms, rec.plain_ms = case(pair, "P=2 m=32,50", rows=rows_main)
    case(wide, "P=64 m=50")
    case(mid, "P=2 m=70,80")


def phase_e2e_k0(dev, mb: int = 256) -> None:
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
    counts = sc.count(syn)
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
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = sc.count(syn)
        secs.append(time.perf_counter() - t0)
        need(again.tolist() == expected, f"{mb} MB k=0: repeat counts differ")
    mbps = len(syn) / statistics.median(secs) / 1e6
    say(f"phase 4 e2e k=0 {mb} MB: gate ok, counts {counts.tolist()}, median "
        f"{mbps:.1f} MB/s over 3 reps (host fold + host-to-device copy "
        f"included; {torch.cuda.get_device_name(0) if dev.type == 'cuda' else dev})")


def phase_e2e_dp(dev, mb: int = 32) -> None:
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
        counts = sc.count(c)
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


def phase_cli(device: str = "cuda") -> None:
    from apm_torch.utils.corpus import plant, random_corpus, random_pattern
    from apm_torch.utils.oracle import count_matches

    c = random_corpus(200_000, seed=60)
    p1, p2 = random_pattern(40, seed=61), random_pattern(12, seed=62)
    plant(c, p1, [500, 90_000, 199_980], k=1, seed=63)
    plant(c, p2, [1234, 150_000], k=0)
    pats = [p1.tobytes().decode(), p2.tobytes().decode()]
    fd, path = tempfile.mkstemp(suffix=".fa")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(c.tobytes())
        r = subprocess.run(
            [sys.executable, "-m", "apm_torch", "1", path, *pats, "--device", device],
            capture_output=True, text=True, cwd=REPO, timeout=600,
        )
    finally:
        os.unlink(path)
    need(r.returncode == 0, f"CLI exit {r.returncode}: {r.stderr[-2000:]}")
    counts = count_matches(c, [p.encode() for p in pats], 1)
    want = [
        f"Approximate Pattern Mathing: looking for 2 pattern(s) in file {path} w/ distance of 1"
    ] + [f"Number of matches for pattern <{p}>: {n}" for p, n in zip(pats, counts)]
    got = [l for l in r.stdout.splitlines() if not l.startswith("APM done in ")]
    need(got == want, f"CLI output {got} != {want}")
    say(f"phase 6 CLI: output lines equal the oracle's, counts {counts}")


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

    from apm_torch.ops import _build, corr_fused, dp_kernel

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = [l.strip() for l in _build.build_log().splitlines() if "registers" in l]
    say(f"phase 1 environment: torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)}; "
        f"kernels built/loaded in {build_s:.1f} s; ptxas: {' | '.join(regs[:3])}")
    dev = torch.device("cuda", 0)

    rec_a = KernelRecord("dp_band", "apm_torch/csrc/dp_band.cu",
                         "apm/ops/pallas_kernel.py:593")
    rec_b = KernelRecord("corr_fused", "apm_torch/csrc/corr_fused.cu",
                         "apm/ops/corr_fused.py:298")
    phase_dp(rec_a, dev)
    phase_corr(rec_b, dev)

    # The main path: counters from zero, read after the end-to-end phases.
    dp_kernel.LAUNCHES = 0
    corr_fused.LAUNCHES = 0
    for mb in (256, 512):  # one chunk, then two
        phase_e2e_k0(dev, mb)
    phase_e2e_dp(dev)
    launches = {"dp_band": dp_kernel.LAUNCHES, "corr_fused": corr_fused.LAUNCHES}
    need(all(v > 0 for v in launches.values()), f"a kernel never launched on the main path: {launches}")
    say(f"main path launches: {launches}")
    phase_cli()
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [rec_a.json(launches["dp_band"]), rec_b.json(launches["corr_fused"])]}))
    return {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }


def main() -> int:
    try:
        result = run(time.perf_counter())
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
