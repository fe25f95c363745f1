"""A whole genome on one card, at a CPU test's size: a corpus of many
chunks against the benchmark's plain reference (``benchmark/reference.py``)
with the ``repeat_k3`` traffic's pattern shapes (one 32-byte and five
50-byte cuts of 50-base lines, k = 3) on both phase-2 routes that traffic
takes; window starts past 2^31 and 2^32, where a genome's last chunks lie,
through phase 2's packed vector and the verify of the clipped row; the
``#chunks`` counter; and ``count_batch``'s block pairs, which stay within a
block whatever the corpus's length."""

import dataclasses

import numpy as np
import pytest
import torch

from apm_torch import ApmConfig, Scanner
from apm_torch.models.pipeline import FilterChunk, buf_reader, finalize_filtration, make_plan
from apm_torch.ops import dp_kernel, fused
from apm_torch.ops.common import fold_corpus
from apm_torch.utils.oracle import count_matches
from benchmark import corpus as gen
from benchmark import reference

K = 3
LINE = 50
CUTS = [{"length": 32, "count": 1}, {"length": 50, "count": 5}]  # repeat_k3's
CPU = dict(device="cpu", block_windows=1024)  # rows of 128 windows
CHUNK = 4096  # windows a chunk: 32 rows
# 11 whole chunks, then 15 rows and 100 windows: the last chunk is partial
# and its row 15 holds the device bound
DEV_BOUND = 11 * CHUNK + 15 * 128 + 100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genome(dev_bound, seed, copies32=3):
    """A text whose device bound at m_max = 50 is ``dev_bound``, in 50-base
    lines, and the traffic's six patterns cut from it (0 to k substitutions
    each), with near copies (0 to k substitutions): ``copies32`` of the
    32-mer three rows apart from the start, then three of each 50-mer over
    whole lines drawn from the rest; one more 50-mer copy starts in the row
    that holds the device bound (the clipped row), and the first 50-mer's
    first 40 bytes end the text (an EOF-truncated match)."""
    n = dev_bound + LINE - 1
    out = np.array(gen.dna_lines(n, LINE, seed, "cpu"))
    pats = gen.cut_patterns(out, LINE, CUTS, K, gen.stream(seed, 1, 0))
    rng = np.random.default_rng(seed)

    def put(at, pat):
        copy = gen.substitute(pat, int(rng.integers(K + 1)), rng)
        out[at: at + len(copy)] = np.frombuffer(copy, np.uint8)

    for r in range(copies32):
        put(r * 3 * 128 + 7, pats[0])
    first = -(-(copies32 * 3 * 128 + 64) // (LINE + 1))
    lines = first + rng.permutation((dev_bound - 200) // (LINE + 1) - first)[:15]
    for i, line in enumerate(lines):
        put(int(line) * (LINE + 1), pats[1 + i % 5])
    put(dev_bound - dev_bound % 128 + 5, pats[2])
    out[n - 41: n - 1] = np.frombuffer(pats[1][:40], np.uint8)
    out.setflags(write=False)
    return out, pats


@pytest.mark.parametrize("route,copies32", [("device-verify", 3), ("split-rescan", 100)])
def test_a_genome_of_many_chunks_counts_as_the_reference(route, copies32):
    """Twelve chunks, the last partial, counted as the plain reference
    counts them: on the device-verify route, and on the split rescan where
    a hundred copies of the 32-mer make the set dense. The clipped row of
    the last chunk holds a 50-mer's copy and the EOF tail a match."""
    text, pats = _genome(DEV_BOUND, 23 + copies32, copies32)
    sc = Scanner(pats, K, ApmConfig(chunk_bytes=CHUNK, **CPU))
    assert sc.device_window_bound(len(text)) == DEV_BOUND
    sc.meter.trace = True
    got = sc.count(text)
    assert sc.meter.last_spans["#chunks"] == 12
    assert sc.last_filtration["route"] == route
    if route == "split-rescan":  # the 50-mers verified on their hot rows
        sparse = sc.last_filtration["sparse"]
        assert sorted(len(sc.scan_patterns.raw[s]) for s in sparse) == [50] * 5
    want = reference.count_many([text], pats, K, "cpu")[0]
    assert got.tolist() == want.tolist()
    assert (want >= 3).all()
    assert (reference.count_many([text], pats, K, "cpu", eof=False)[0] < want).any()


@pytest.mark.parametrize("base", [0, 2**31 + 3 * 128, 2**32 + 5 * 128 + 7])
def test_a_clipped_row_past_2_31_is_verified(base):
    """One staged chunk whose first window is ``base``: phase 2's packed
    vector carries the clipped row's global start exactly, past 2^31 and
    past 2^32 too, and ``finalize_filtration`` verifies that row, so the
    chunk's counts and its EOF tail add up to the reference's counts."""
    dev_local = 40 * 128 + 100
    text, pats = _genome(dev_local, 5)
    sc = Scanner(pats, K, ApmConfig(**CPU))
    local = make_plan(sc, len(text))
    assert local.dev_bound == dev_local
    st = sc._count_setup(local)
    plan = dataclasses.replace(local, dev_bound=base + dev_local)
    rows = torch.from_numpy(fold_corpus(text, 0, st.n_rows, plan.wf, plan.halo))
    _, fl = sc._launch_chunk(st, rows, base, bound=plan.dev_bound)
    p_pad = sc._pat.shape[0]
    fcnt, vcnt, n_hot, clips = fused.unpack_chunk(fl.packed.numpy(), p_pad)
    assert clips[clips >= 0].tolist() == [base + 40 * 128]

    def reader(j0, length):
        return buf_reader(text)(j0 - base, length)

    def rescan():
        raise AssertionError("a set this sparse is verified, not rescanned")

    got, info = finalize_filtration(
        reader, plan, base + len(text), [FilterChunk(base, fcnt, vcnt, n_hot, clips, fl.rowmap)],
        rescan, max_hot=st.max_hot, **sc._host_verify(plan))
    assert info["route"] == "device-verify"
    n_scan = sc.scan_patterns.num_patterns
    got = (got[:n_scan] + sc.tail_counts(text, dev_local))[sc._inverse]
    assert got.tolist() == reference.count_many([text], pats, K, "cpu")[0].tolist()
    assert fl.packed.dtype == torch.int64


@pytest.mark.parametrize("k", [0, 3])
def test_chunks_counter_counts_the_chunks_launched(monkeypatch, k):
    """``#chunks`` is the number of chunks the call launched, traced; an
    untraced call records nothing."""
    text, pats = _genome(5 * CHUNK + 1000, 41)
    launches = []
    real = Scanner._launch_chunk

    def spy(self, st, drows, c0, *a, **kw):
        launches.append(c0)
        return real(self, st, drows, c0, *a, **kw)

    monkeypatch.setattr(Scanner, "_launch_chunk", spy)
    sc = Scanner(pats, k, ApmConfig(chunk_bytes=CHUNK, **CPU))
    want = sc.count(text).tolist()
    assert sc.meter.last_spans == {} and len(launches) == 6
    sc.meter.trace = True
    assert sc.count(text).tolist() == want
    assert sc.meter.last_spans["#chunks"] == len(launches) - 6 == 6
    assert launches[6:] == [c * CHUNK for c in range(6)]


def test_count_batch_block_pairs_stay_within_a_block(monkeypatch):
    """``count_batch`` hands the batch kernels each block's bound and start
    from the block's first window, which int32 holds for any corpus, and
    counts as the oracle does."""
    corpora = [gen.dna_lines(n, LINE, 60 + n, "cpu") for n in (3000, 9000, 20_000)]
    pats = gen.cut_patterns(corpora[2], LINE, CUTS, K, gen.stream(7, 1, 0))
    seen = []
    real = dp_kernel.scan_folded_dp_batch

    def spy(rows, pat, meta, *a, **kw):
        seen.append(meta.numpy().copy())
        return real(rows, pat, meta, *a, **kw)

    monkeypatch.setattr(dp_kernel, "scan_folded_dp_batch", spy)
    sc = Scanner(pats, K, ApmConfig(**CPU))
    got = sc.count_batch(corpora)
    assert got.tolist() == [count_matches(c, pats, K) for c in corpora]
    meta = np.concatenate(seen)
    assert meta.dtype == np.int32 and (meta[:, 1] == 0).all()
    assert meta[:, 0].max() == 1024 and (meta[:, 0] % 128 != 0).any()

