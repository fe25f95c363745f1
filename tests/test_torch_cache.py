"""The port's device corpus cache: full-content keys, byte bounds, the
fingerprint memo, the warmup purge, and the staging it saves.

The eight tests of ``tests/test_cache.py`` run here over the port
(``apm_torch.Scanner(..., ApmConfig(device="cpu"))``), as parametrised cases
where a second configuration reaches other code; counts are held to the
oracle and, where the corpus is small, to ``apm`` (Pallas in interpret
mode), fingerprints to ``apm``'s. Then what the cache buys: a repeated
corpus is neither folded nor copied, and the density rescan stages no chunk
a second time under either ``cache_corpus`` setting. Counts and keys are
integers: the tolerance is 0 throughout.
"""

import gc
import time

import numpy as np
import pytest
import torch

import apm
from apm import ApmConfig as JaxConfig
from apm.utils.oracle import count_matches

import apm_torch
from apm_torch import ApmConfig
from apm_torch.models import scanner as scanner_mod

PORT = dict(device="cpu", block_windows=1024)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n, seed, alphabet=b"ACGT\n"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


@pytest.fixture(scope="module")
def apm_native():
    """``apm.utils.native`` with its library loaded (``apm``'s fingerprint
    falls back to BLAKE2b without it). Test workers that start together may
    open ``native/libapmio.so`` while another worker's ``g++`` still writes
    it, and ``apm``'s loader then gives up for the process: wait, and load
    again."""
    from apm.utils import native

    deadline = time.monotonic() + 120
    while native._load() is None:
        if time.monotonic() > deadline:
            raise RuntimeError("apm's native library did not load")
        time.sleep(0.5)
        native._load_attempted = False
    return native


def _cached_bytes(sc) -> int:
    return sum(v.numel() * v.element_size() for v in sc._dev_cache.values())


@pytest.fixture
def fold_spy(monkeypatch):
    """Counts the Scanner's host folds (each staged chunk is one)."""
    calls = []
    real = scanner_mod.fold_corpus

    def spy(buf, c0, *args, **kw):
        calls.append(c0)
        return real(buf, c0, *args, **kw)

    monkeypatch.setattr(scanner_mod, "fold_corpus", spy)
    return calls


# -- the eight tests of tests/test_cache.py, over the port ---------------------


@pytest.mark.parametrize("engine", ["filter", "dp"])
def test_inplace_mutation_invalidates_cache(engine):
    """One byte changed in place between two counts of the same writable
    buffer: the second scan sees the new content (the key hashes every
    byte)."""
    data = _corpus(100_000, 7)
    pat = bytes(data[5000:5030])  # an exact match at 5000
    sc = apm_torch.Scanner([pat], 0, ApmConfig(engine=engine, **PORT))
    before = sc.count(data).tolist()
    assert before == count_matches(data, [pat], 0)
    assert sc._dev_cache
    data[5011] ^= 0xFF
    after = sc.count(data).tolist()
    assert after == count_matches(data, [pat], 0)
    assert after != before


@pytest.mark.parametrize("engine", ["filter", "dp"])
def test_second_corpus_same_length_not_conflated(engine):
    data1 = _corpus(50_000, 8)
    data2 = data1.copy()
    data2[30_001] ^= 1  # differs in one byte
    pat = bytes(data1[30_000:30_020])
    sc = apm_torch.Scanner([pat], 0, ApmConfig(engine=engine, **PORT))
    c1 = sc.count(data1).tolist()
    c2 = sc.count(data2).tolist()
    assert c1 == count_matches(data1, [pat], 0)
    assert c2 == count_matches(data2, [pat], 0)
    assert c1 != c2 and len(sc._dev_cache) == 2


@pytest.mark.parametrize("budget,entries", [(0, 0), (1 << 20, 0), (3 << 20, 2), (None, 4)])
def test_cache_byte_budget_evicts(budget, entries):
    """The cache never holds more bytes than its budget (a chunk larger
    than the budget is not kept at all), evicts least recently used
    first, and defaults to 4 GB off the card."""
    sc = apm_torch.Scanner([b"ACGTACGTAC"], 0, ApmConfig(cache_bytes=budget, **PORT))
    corpora = [_corpus(600_000, 100 + seed) for seed in range(4)]
    for c in corpora:
        assert sc.count(c).tolist() == count_matches(c, [b"ACGTACGTAC"], 0)
    assert len(sc._dev_cache) == entries
    assert _cached_bytes(sc) <= (4 << 30 if budget is None else budget)
    assert sc._cache_byte_budget() == (4 << 30 if budget is None else budget)
    if entries:  # the most recent corpora stay
        kept = {key[0] for key in sc._dev_cache}
        assert kept == {sc._fingerprint(c) for c in corpora[-entries:]}


@pytest.mark.parametrize("n", [10_000, (9 << 20) + 3])
def test_fingerprint_full_content(n, apm_native):
    buf = _corpus(n, 9)
    fp1 = apm_torch.Scanner._fingerprint(buf)
    assert fp1 == apm.Scanner._fingerprint(buf)  # the same key as apm's
    buf2 = buf.copy()
    buf2[n * 3 // 7] ^= 2
    assert apm_torch.Scanner._fingerprint(buf2) != fp1
    assert apm_torch.Scanner._fingerprint(buf.copy()) == fp1


@pytest.mark.parametrize("kind", ["frozen", "memmap", "frombuffer"])
def test_corpus_fp_memoizes_immutable_only(kind, tmp_path):
    """Immutable buffers hash once (memoized by identity); writable
    buffers hash every call; a read-only view of a writable base is not
    immutable; a dead array leaves the memo."""
    sc = apm_torch.Scanner([b"ACGTACGTAC"], 0, ApmConfig(**PORT))
    data = _corpus(20_000, 11)
    if kind == "frozen":
        buf = data.copy()
        buf.setflags(write=False)
    elif kind == "memmap":
        data.tofile(tmp_path / "c")
        buf = np.memmap(tmp_path / "c", dtype=np.uint8, mode="r")
    else:
        buf = np.frombuffer(data.tobytes(), dtype=np.uint8)
    assert apm_torch.Scanner._immutable(buf)
    fp1 = sc._corpus_fp(buf)
    assert fp1 == sc._corpus_fp(buf) == sc._fingerprint(data)
    assert id(buf) in sc._fp_memo
    # writable: never memoized
    mut = _corpus(20_000, 12)
    sc._corpus_fp(mut)
    assert id(mut) not in sc._fp_memo
    # read-only view of a writable base: not immutable
    view = mut[:]
    view.setflags(write=False)
    assert not apm_torch.Scanner._immutable(view)
    sc._corpus_fp(view)
    assert id(view) not in sc._fp_memo
    # with the cache off there is no key at all
    off = apm_torch.Scanner([b"ACGT"], 0, ApmConfig(cache_corpus=False, **PORT))
    assert off._corpus_fp(buf) is None and off._fp_memo == {}
    # a dead array leaves the memo through its weak reference
    key = id(buf)
    del buf
    gc.collect()
    assert key not in sc._fp_memo


@pytest.mark.parametrize("engine", ["filter", "auto"])
def test_count_correct_after_freezing_and_new_buffer(engine):
    """Scans of a frozen buffer and a same-shape successor (which may
    recycle its id) stay content-correct, and equal apm's."""
    pat = b"TTTTTTTTTTGG"
    sc = apm_torch.Scanner([pat], 0, ApmConfig(engine=engine, **PORT))
    jsc = apm.Scanner([pat], 0, JaxConfig(engine=engine, backend="pallas", interpret=True,
                                          block_windows=1024))
    a = _corpus(30_000, 14).copy()
    a[100 : 100 + len(pat)] = np.frombuffer(pat, np.uint8)
    a.setflags(write=False)
    want = count_matches(a, [pat], 0)
    assert sc.count(a).tolist() == want == jsc.count(a).tolist()
    del a
    b = _corpus(30_000, 15)
    b.setflags(write=False)
    assert sc.count(b).tolist() == count_matches(b, [pat], 0)


@pytest.mark.parametrize("foreground", ["random", "zeros"])
def test_warmup_purge_scoped_to_zero_corpus(foreground):
    """warmup() may run on the prewarm thread beside real scans: its purge
    removes only the zero-corpus entries it staged. A foreground corpus's
    rows and memoized fingerprint stay, even a foreground corpus of zeros
    (the same key) staged before the warmup."""
    pat = b"ACGTACGTAC"
    sc = apm_torch.Scanner([pat], 0, ApmConfig(**PORT))
    real = _corpus(20_000, 21) if foreground == "random" else np.zeros(20_000, np.uint8)
    real.setflags(write=False)
    want = count_matches(real, [pat], 0)
    assert sc.count(real).tolist() == want
    keys_before = set(sc._dev_cache)
    assert keys_before and id(real) in sc._fp_memo
    sc.warmup(20_000)
    assert keys_before <= set(sc._dev_cache)
    assert id(real) in sc._fp_memo
    zfp = apm_torch.Scanner._fingerprint(np.zeros(20_000, np.uint8))
    assert {k for k in sc._dev_cache if k[0] == zfp} == {
        k for k in keys_before if k[0] == zfp
    }
    assert sc.count(real).tolist() == want


@pytest.mark.parametrize("pkg", ["apm_torch", "apm"])
def test_as_u8_multi_element_string_array_rejected(pkg):
    from importlib import import_module

    as_u8 = import_module(f"{pkg}.utils.oracle").as_u8
    with pytest.raises(ValueError):
        as_u8(np.array(["AC", "GT"]))
    with pytest.raises(ValueError):
        as_u8(np.array([b"AC", b"GT"]))
    # scalars / single elements stay supported, without NUL padding
    assert as_u8(np.array("ACGT")).tobytes() == b"ACGT"
    assert as_u8(np.array([b"AC"], dtype="S4")).tobytes() == b"AC"
    assert as_u8(np.array([], dtype="U4")).size == 0
    # a contiguous uint8 array comes back as itself: the memo's identity
    a = np.zeros(5, np.uint8)
    assert as_u8(a) is a


def test_fp_memo_detects_refrozen_mutation():
    """A frozen buffer thawed, changed in place where the memo samples it,
    and frozen again is not served stale counts (tests/test_batch.py's
    test over the port)."""
    pat = _corpus(12, 430, b"ACGT").tobytes()
    corpus = _corpus(4000, 431)
    corpus[20:32] = np.frombuffer(pat, np.uint8)
    corpus.setflags(write=False)
    sc = apm_torch.Scanner([pat], 0, ApmConfig(**PORT))
    assert sc.count(corpus).tolist() == count_matches(corpus, [pat], 0)
    assert len(sc._fp_memo) == 1
    corpus.setflags(write=True)
    corpus[20:32] = 0
    corpus.setflags(write=False)
    assert sc.count(corpus).tolist() == count_matches(corpus, [pat], 0)


# -- what the cache saves --------------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 3])
def test_warm_call_neither_folds_nor_copies(k, fold_spy):
    """A repeated corpus is served from the device cache: the warm call's
    spans hold the fingerprint but no fold and no copy, and no fold
    runs."""
    from apm_torch.utils.corpus import plant

    c = _corpus(60_000, 300 + k)
    p50 = _corpus(50, 302, b"ACGT")
    plant(c, p50, range(700, len(c) - 100, 9_000), k=k, seed=303)
    pats = [bytes(c[2000:2032]), p50.tobytes()]
    sc = apm_torch.Scanner(pats, k, ApmConfig(chunk_bytes=16 << 10, **PORT))
    sc.meter.trace = True
    want = count_matches(c, pats, k)
    assert sc.count(c).tolist() == want
    n_chunks = len(fold_spy)
    assert n_chunks >= 3 and {"fingerprint", "fold", "copy"} <= set(sc.meter.last_spans)
    frozen = c.copy()
    frozen.setflags(write=False)
    for buf in (c, frozen, frozen):  # writable: hashed; frozen: memoized
        assert sc.count(buf).tolist() == want
        assert "fingerprint" in sc.meter.last_spans
        assert not {"fold", "copy"} & set(sc.meter.last_spans)
    assert len(fold_spy) == n_chunks
    assert len(sc._dev_cache) == n_chunks


@pytest.mark.parametrize("cache_corpus", [True, False])
def test_dense_k3_rescan_stages_each_chunk_once(cache_corpus, fold_spy):
    """The k = 3 dense cell takes the density rescan, which reads the rows
    the first pass staged: one fold per chunk in the call, with the cache
    on or off."""
    from apm_torch.utils.corpus import plant

    pats = [_corpus(32, 50, b"ACGT").tobytes(), _corpus(50, 51, b"ACGT").tobytes()]
    c = _corpus(40_000, 52)
    for i, p in enumerate(pats):
        plant(c, np.frombuffer(p, np.uint8), range(400 + 97 * i, len(c) - 300, 150),
              k=3, seed=53 + i)
    sc = apm_torch.Scanner(pats, 3, ApmConfig(chunk_bytes=16 << 10, cache_corpus=cache_corpus,
                                              **PORT))
    assert sc.count(c).tolist() == count_matches(c, pats, 3)
    assert sc.last_filtration["route"] == "rescan"
    chunks = -(-sc.device_window_bound(len(c)) // (16 << 10))
    assert chunks >= 2 and sorted(fold_spy) == [i * (16 << 10) for i in range(chunks)]
    assert len(sc._dev_cache) == (chunks if cache_corpus else 0)


def test_find_reads_the_rows_count_staged(fold_spy):
    """find() on the corpus a count() just staged takes its rows from the
    cache; count_batch() stages without it, as in apm."""
    c = _corpus(50_000, 60)
    pats = [bytes(c[100:132]), bytes(c[7000:7050])]
    sc = apm_torch.Scanner(pats, 1, ApmConfig(**PORT))
    counts = sc.count(c)
    n_folds = len(fold_spy)
    pos = sc.find(c)
    assert [len(p) for p in pos] == counts.tolist()
    assert len(fold_spy) == n_folds
    keys = set(sc._dev_cache)
    assert sc.count_batch([c]).tolist() == [counts.tolist()]
    assert set(sc._dev_cache) == keys
