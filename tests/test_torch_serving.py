"""The port's serving surface beside ``count``: ``count_file``,
``count_stream``, ``warmup`` and the prewarm thread (``prewarm_bytes``,
``prewarm_join``), against ``count``, ``apm`` (Pallas in interpret mode)
and the oracle. Counts are integers: the tolerance is 0 throughout.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import apm
from apm import ApmConfig as JaxConfig
from apm.utils.oracle import count_matches

import apm_torch
from apm_torch import ApmConfig

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


def _split_stream(buf, sizes, rng):
    """Yield buf in pieces of pseudo-random sizes, empty pieces included."""
    i = 0
    while i < len(buf):
        s = int(sizes[int(rng.integers(0, len(sizes)))])
        yield bytes(buf[i : i + s])
        i += s
        if int(rng.integers(0, 4)) == 0:
            yield b""  # empty pieces must be harmless


# -- count_file and count_stream ---------------------------------------------------


@pytest.mark.parametrize("k", [0, 1, 3])
def test_count_file_matches_count(k, tmp_path):
    from apm_torch.utils.corpus import plant

    c = _corpus(40_000, 10 + k)
    p50 = _corpus(50, 11, b"ACGT")
    plant(c, p50, [700, 19_000, 39_950], k=k, seed=12)
    pats = [p50.tobytes(), bytes(c[5000:5032]), p50.tobytes()]
    path = tmp_path / "db.fa"
    c.tofile(path)
    sc = apm_torch.Scanner(pats, k, ApmConfig(**PORT))
    want = count_matches(c, pats, k)
    assert sc.count(c).tolist() == want
    assert sc.count_file(path).tolist() == want
    assert sc.count_file(str(path)).tolist() == want
    jsc = apm.Scanner(pats, k, JaxConfig(backend="pallas", interpret=True, block_windows=1024))
    assert jsc.count_file(str(path)).tolist() == want


@pytest.mark.parametrize(
    "k,sizes,segment",
    [(0, [1, 37, 256, 1000], 500), (1, [1, 37, 256, 1000], 500),
     (3, [513, 64], 700), (1, [4096], None), (3, [1, 2999], 2000)],
)
def test_count_stream_matches_count(k, sizes, segment):
    """count_stream == count(concatenation) over chunkings, with matches
    straddling every segment boundary the stream cuts."""
    rng = np.random.default_rng(40 + k)
    corpus = _corpus(9000, 70 + k).copy()
    pat = _corpus(50, 71)
    short = _corpus(7, 72)
    for pos in [480, 990, 1490, 2990, 5990, 8940]:
        corpus[pos : pos + 50] = pat
    pats = [pat, short, pat]
    sc = apm_torch.Scanner(pats, k, ApmConfig(**PORT))
    want = sc.count(corpus)
    assert want.tolist() == count_matches(corpus, pats, k)
    got = sc.count_stream(_split_stream(corpus, sizes, rng), segment_bytes=segment)
    assert got.tolist() == want.tolist()
    # segments went through the sibling with the cache off: the parent's
    # cache holds the one corpus count() staged
    assert sc._stream_scanner is not None and not sc._stream_scanner._dev_cache
    assert len({key[0] for key in sc._dev_cache}) == 1


def test_count_stream_tiny_and_empty():
    sc = apm_torch.Scanner([b"ACG"], 1, ApmConfig(**PORT))
    assert sc.count_stream(iter([])).tolist() == [0]
    assert sc.count_stream(iter([b""])).tolist() == [0]
    # a stream shorter than the pattern: EOF truncation only
    assert sc.count_stream(iter([b"AC"])).tolist() == count_matches(b"AC", [b"ACG"], 1)
    # with the cache off the parent counts its own segments
    off = apm_torch.Scanner([b"ACG"], 1, ApmConfig(cache_corpus=False, **PORT))
    c = _corpus(3000, 73)
    assert off.count_stream(iter([bytes(c[:1000]), bytes(c[1000:])]), segment_bytes=600).tolist() \
        == count_matches(c, [b"ACG"], 1)
    assert off._stream_scanner is None


# -- warmup --------------------------------------------------------------------


@pytest.mark.parametrize("k,lengths", [(0, [50, 32]), (2, [50, 8]), (3, [32, 50])])
def test_warmup_covers_serving_paths(k, lengths):
    """After warmup(n) the first count, find and count_batch of an n-byte
    corpus build no device table (tests/test_batch.py's jit-cache check,
    where the port's first-use work is its tables), and agree with the
    oracle."""
    from apm_torch.utils.corpus import random_pattern

    n = 20_000
    pats = [random_pattern(m, seed=501 + i).tobytes() for i, m in enumerate(lengths)]
    sc = apm_torch.Scanner(pats, k, ApmConfig(**PORT))
    assert sc._dev_tables == {}
    sc.warmup(n)
    tables = set(sc._dev_tables)
    assert "pat" in tables
    corpus = _corpus(n, 503)
    want = count_matches(corpus, pats, k)
    assert sc.count(corpus).tolist() == want
    assert [len(p) for p in sc.find(corpus)] == want
    assert sc.count_batch([corpus]).tolist() == [want]
    assert set(sc._dev_tables) == tables


def test_warmup_leaves_corpus_caches_clean():
    """The zero corpus driven through find()/count_batch() during warmup
    occupies neither the device cache nor the fingerprint memo."""
    sc = apm_torch.Scanner([_corpus(20, 504, b"ACGT").tobytes()], 1, ApmConfig(**PORT))
    sc.warmup(8000)
    assert sc._dev_cache == {}
    assert sc._fp_memo == {}


@pytest.mark.parametrize("paths", [("count",), ("find",), ("batch",), ("count", "find", "batch")])
def test_warmup_compiles_then_counts(paths):
    corpus = _corpus(5000, 71)
    pats = [_corpus(50, 72).tobytes(), b"ACG"]
    sc = apm_torch.Scanner(pats, 1, ApmConfig(device="cpu"))
    sc.warmup(len(corpus), paths=paths)
    assert sc.count(corpus).tolist() == count_matches(corpus, pats, 1)


def test_warmup_arguments():
    sc = apm_torch.Scanner([b"ACGTACGT"], 2, ApmConfig(**PORT))
    with pytest.raises(ValueError, match="unknown warmup paths"):
        sc.warmup(1000, paths=("count", "serve"))
    sc.warmup(2)  # nothing to scan: builds the host library, runs nothing
    assert sc._dev_tables == {} and sc._dev_cache == {}


# -- prewarm ---------------------------------------------------------------------


def test_prewarm_background_thread():
    """prewarm_bytes warms on a daemon thread; counts stay right whether a
    scan races the prewarm or waits for it."""
    corpus = _corpus(5000, 73)
    pats = [_corpus(50, 74).tobytes(), b"ACG"]
    sc = apm_torch.Scanner(pats, 1, ApmConfig(device="cpu", prewarm_bytes=len(corpus)))
    assert sc._prewarm_thread.daemon and sc._prewarm_thread.name == "apm-prewarm"
    racing = sc.count(corpus).tolist()  # races the prewarm on purpose
    assert sc.prewarm_join(timeout=120.0)
    assert not sc._prewarm_thread.is_alive()
    want = count_matches(corpus, pats, 1)
    assert racing == want
    assert sc.count(corpus).tolist() == want


def test_prewarm_join_without_prewarm():
    sc = apm_torch.Scanner([b"ACG"], 0, ApmConfig(device="cpu"))
    assert sc._prewarm_thread is None
    assert sc.prewarm_join() is True


def test_prewarm_join_raises_a_recorded_failure(monkeypatch):
    """A failed prewarm is not swallowed: prewarm_join raises it, every
    time, with the failure as its cause."""
    release = threading.Event()

    def failing(self, corpus_bytes, paths=("count", "find", "batch")):
        release.wait(60)
        raise RuntimeError("nvcc failed: kernel build")

    monkeypatch.setattr(apm_torch.Scanner, "warmup", failing)
    sc = apm_torch.Scanner([b"ACG"], 0, ApmConfig(device="cpu", prewarm_bytes=1000))
    assert sc.prewarm_join(timeout=0.01) is False  # still running
    release.set()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="prewarm failed") as err:
            sc.prewarm_join(timeout=60)
        assert "nvcc failed" in str(err.value.__cause__)


def test_cache_under_concurrent_scans_and_warmup():
    """More threads than cores count different corpora on one Scanner
    with a cache that holds two chunks, beside warmups of the same size,
    at a short switch interval: every count stays right and the cache
    stays within its budget (a lost update or an iteration over a
    changing dict would break one or the other)."""
    pats = [b"ACGTACGTAC", _corpus(30, 80, b"ACGT").tobytes()]
    corpora = [_corpus(20_000, 81 + i) for i in range(6)]
    wants = [count_matches(c, pats, 1) for c in corpora]
    probe = apm_torch.Scanner(pats, 1, ApmConfig(**PORT))
    probe.count(corpora[0])
    chunk = next(iter(probe._dev_cache.values())).numel()
    sc = apm_torch.Scanner(pats, 1, ApmConfig(cache_bytes=2 * chunk, **PORT))
    errors = []

    def work(i):
        try:
            for r in range(3):
                if i % 4 == 3 and r == 1:
                    sc.warmup(20_000)
                c = corpora[(i + r) % len(corpora)]
                if sc.count(c).tolist() != wants[(i + r) % len(corpora)]:
                    errors.append(f"thread {i} round {r}: wrong counts")
        except Exception as e:  # reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert sum(v.numel() for v in sc._dev_cache.values()) <= 2 * chunk
