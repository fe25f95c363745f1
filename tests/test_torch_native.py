"""The port's native host layer (``apm_torch/csrc/host/apmio.cpp`` through
``apm_torch.utils.native``) against ``apm``'s (``apm.utils.native``), the
NumPy fold ``fold_corpus_ref`` and the oracle.

Every output compared here is bytes, an integer count or a 64-bit hash, so
the tolerance is 0 throughout. The library is built with ``g++`` at first
use; a missing compiler or a failed build raises, and nothing falls back to
NumPy.
"""

import time

import numpy as np
import pytest
import torch

from apm.ops.common import fold_corpus as apm_fold

from apm_torch.ops import _build
from apm_torch.ops.common import fold_corpus, fold_corpus_ref
from apm_torch.utils import native
from apm_torch.utils.oracle import banded_distances


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def apm_native():
    """``apm.utils.native`` with its library loaded. Test workers that
    start together may open ``native/libapmio.so`` while another worker's
    ``g++`` still writes it, and ``apm``'s loader then gives up for the
    process: wait, and load again."""
    from apm.utils import native

    deadline = time.monotonic() + 120
    while native._load() is None:
        if time.monotonic() > deadline:
            raise RuntimeError("apm's native library did not load")
        time.sleep(0.5)
        native._load_attempted = False
    return native


def _corpus(n, seed, alphabet=b"ACGT\n"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


FOLD_CASES = [
    # n, offset, n_rows, wf, halo
    (5000, 0, 8, 512, 128),  # rows past EOF
    (5000, 1024, 8, 512, 128),  # offset > 0
    (300, 0, 4, 128, 256),  # halo wider than the corpus
    (4096, 4096, 3, 128, 128),  # offset at EOF: all zero rows
    (9000, 7000, 2, 1000, 0),  # no halo
    (70_000, 128, 64, 1024, 128),  # every row inside the corpus
]


@pytest.mark.parametrize("n,offset,n_rows,wf,halo", FOLD_CASES)
def test_fold_matches_ref_and_apm(n, offset, n_rows, wf, halo):
    c = _corpus(n, 7)
    want = fold_corpus_ref(c, offset, n_rows, wf, halo)
    assert np.array_equal(apm_fold(c, offset, n_rows, wf, halo), want)
    assert np.array_equal(fold_corpus(c, offset, n_rows, wf, halo), want)
    assert np.array_equal(native.fold(c, offset, n_rows, wf, halo), want)
    # into a given buffer (the Scanner's page-locked rows), old bytes gone
    out = np.full((n_rows, wf + halo), 0xFF, np.uint8)
    assert fold_corpus(c, offset, n_rows, wf, halo, out=out) is out
    assert np.array_equal(out, want)
    # a strided source is made contiguous over the rows' range only
    wide = np.zeros(2 * n, np.uint8)
    wide[::2] = c
    assert np.array_equal(native.fold(wide[::2], offset, n_rows, wf, halo), want)


def test_fold_from_a_memmap(tmp_path, apm_native):
    c = _corpus(50_000, 8)
    path = tmp_path / "corpus.bin"
    c.tofile(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    for offset, n_rows in ((0, 40), (31_000, 30), (49_900, 2)):
        want = fold_corpus_ref(c, offset, n_rows, 1024, 128)
        assert np.array_equal(fold_corpus(mm, offset, n_rows, 1024, 128), want)
        assert np.array_equal(native.read_folded(path, offset, n_rows, 1024, 128), want)
        assert np.array_equal(apm_native.read_folded(str(path), offset, n_rows, 1024, 128), want)
    del mm


def test_fold_checks_its_arguments():
    c = _corpus(1000, 9)
    with pytest.raises(ValueError, match="out"):
        fold_corpus(c, 0, 4, 128, 128, out=np.zeros((4, 255), np.uint8))
    with pytest.raises(ValueError, match="out"):
        fold_corpus(c, 0, 4, 128, 128, out=np.zeros((256, 4), np.uint8).T)
    with pytest.raises(ValueError, match="uint8"):
        fold_corpus(c.astype(np.int32), 0, 4, 128, 128)
    with pytest.raises(ValueError, match="offset"):
        fold_corpus(c, -1, 4, 128, 128)
    with pytest.raises(ValueError, match="wf"):
        native.fold(c, 0, 4, 0, 128)


@pytest.mark.parametrize("k", list(range(9)))
def test_banded_count_matches_apm_and_oracle(k, apm_native):
    c = _corpus(3000, 10 + k)
    for pat in (bytes(c[100:113]), b"ACGTT", bytes(c[2980:]), bytes(c[500:560])):
        p = np.frombuffer(pat, np.uint8)
        m = len(p)
        d = banded_distances(c, p, k)
        # with EOF truncation: every window of the corpus, as tail_counts asks
        nw = max(0, len(c) - k)
        want = int((d[:nw] <= k).sum())
        assert native.banded_count(c, p, k, nw, len(c)) == want
        assert apm_native.banded_count(c, p, k, nw, len(c)) == want
        # without: the untruncated windows (the clipped-row verifier's use)
        nu = min(len(c) - m + 1, len(c) - k)
        want = int((d[:nu] <= k).sum())
        assert native.banded_count(c, p, k, nu) == want
        assert apm_native.banded_count(c, p, k, nu) == want
        # windows past the text read zero bytes, as apm's do
        assert native.banded_count(c[-40:], p, k, 60) == apm_native.banded_count(c[-40:], p, k, 60)


def test_banded_count_eof_suffix_as_tail_counts_calls_it():
    # the suffix past the device bound, truncated at its own end
    for k in (0, 1, 3, 8):
        c = _corpus(400, 20 + k, b"ACGT")
        pat = np.frombuffer(bytes(c[-30:]) + b"ACGTACGTAC", np.uint8)
        suffix = c[len(c) - len(pat) + 1 :]
        nw = max(0, len(suffix) - k)
        want = int((banded_distances(suffix, pat, k) <= k).sum())
        assert want > 0
        assert native.banded_count(suffix, pat, k, nw, len(suffix)) == want
    with pytest.raises(ValueError, match="pattern"):
        native.banded_count(c, np.zeros(0, np.uint8), 1, 10)
    with pytest.raises(ValueError, match="k >= 0"):
        native.banded_count(c, pat, -1, 10)


def _set_counts_each(text, pats, k, nw, truncate_at):
    """banded_count_set's counts, pattern by pattern through banded_count."""
    return [native.banded_count(text, np.frombuffer(p, np.uint8), k, nw, truncate_at)
            for p in pats]


@pytest.mark.parametrize("eof", [True, False])
@pytest.mark.parametrize("k", [0, 1, 3, 12])
def test_banded_count_set_equals_each_pattern_and_the_oracle(k, eof):
    """One native call over a set of mixed lengths (near copies planted in
    the text and at its end) gives each pattern's banded_count and the
    oracle's count, with EOF truncation (every window of the text, as
    tail_counts asks) and without (the windows every pattern fits)."""
    from apm_torch.utils.corpus import plant

    c = _corpus(3000, 40 + k, b"ACGT")
    pats = [bytes(c[100:105]), bytes(c[700:713]), bytes(c[1200:1250]), b"ACGTTGCA" * 8,
            bytes(c[2000:2120]), bytes(c[-37:]) + b"TTTT"]
    for i, p in enumerate(pats[:5]):
        plant(c, np.frombuffer(p, np.uint8), [1500 + 211 * i], k=min(k, 2), seed=i)
    flat, offsets = native.pattern_set(pats)
    assert offsets.tolist() == [0, 5, 18, 68, 132, 252, 293]
    m_max = max(len(p) for p in pats)
    nw, trunc = (len(c) - k, len(c)) if eof else (len(c) - m_max + 1, -1)
    got = native.banded_count_set(c, flat, offsets, k, nw, trunc)
    assert got.dtype == np.int64 and got.shape == (len(pats),)
    want = [int((banded_distances(c, p, k)[:nw] <= k).sum()) for p in pats]
    assert got.tolist() == _set_counts_each(c, pats, k, nw, trunc) == want
    assert (got[:5] > 0).all()
    if eof:
        assert got[5] > 0  # the last pattern's prefix ends the text


@pytest.mark.parametrize("k", [0, 1, 3, 12])
def test_banded_count_set_on_short_and_empty_suffixes(k):
    """A suffix shorter than every pattern, an empty suffix, one pattern,
    and the capture panel's tail: 64 probes of 120 bytes over the last 119
    bytes of a text (107 windows at k = 12), prefixes of a third of them
    written over its end."""
    c = _corpus(4000, 60 + k, b"ACGT")
    probes = [bytes(_corpus(120, 70 + i, b"ACGT")) for i in range(64)]
    for i in range(0, 64, 3):  # probe i's prefix ends the text
        cut = 119 - 2 * (i % 50)
        c[len(c) - cut :] = np.frombuffer(probes[i][:cut], np.uint8)
    for text, pats in (
        (c[-40:], probes[:4] + [b"ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT"]),
        (c[:0], probes[:3]),
        (c[-300:], probes[5:6]),
        (c[-119:], probes),
    ):
        flat, offsets = native.pattern_set(pats)
        nw = max(0, len(text) - k)
        got = native.banded_count_set(text, flat, offsets, k, nw, len(text))
        want = [int((banded_distances(text, p, k) <= k).sum()) for p in pats]
        assert got.tolist() == _set_counts_each(text, pats, k, nw, len(text)) == want
    assert want[63] > 0  # the last probe written ends the text: counted there


def test_banded_count_set_checks_its_arguments():
    c = _corpus(500, 3, b"ACGT")
    flat, offsets = native.pattern_set([b"ACGT", b"GGTTA"])
    assert native.banded_count_set(c, flat, offsets, 1, 400).shape == (2,)
    empty, none = native.pattern_set([])
    assert native.banded_count_set(c, empty, none, 1, 400).shape == (0,)
    for bad in ([1, 4, 9], [0, 4, 8], [0, 4, 4, 9], [0, 5, 4, 9], [[0, 4, 9]], []):
        with pytest.raises(ValueError, match="offsets"):
            native.banded_count_set(c, flat, np.asarray(bad, np.int64), 1, 400)
    with pytest.raises(ValueError, match="k >= 0"):
        native.banded_count_set(c, flat, offsets, -1, 400)
    with pytest.raises(ValueError, match="n_windows >= 0"):
        native.banded_count_set(c, flat, offsets, 1, -1)
    with pytest.raises(ValueError, match="uint8"):
        native.banded_count_set(c.astype(np.int32), flat, offsets, 1, 400)
    with pytest.raises(ValueError, match="uint8"):
        native.banded_count_set(c, flat.astype(np.int16), offsets, 1, 400)


def test_banded_count_set_from_two_threads_at_once():
    """Two threads in the native call at once (it holds no shared state)
    give what one thread alone gives."""
    import threading

    c = _corpus(20_000, 5, b"ACGT")
    pats = [bytes(c[i : i + 120]) for i in range(19_000, 19_880, 55)]
    flat, offsets = native.pattern_set(pats)
    want = native.banded_count_set(c[-2000:], flat, offsets, 12, 1988, 2000)
    assert (want > 0).all()
    start = threading.Barrier(2)
    got = [None, None]

    def run(i):
        start.wait(timeout=60)
        got[i] = [native.banded_count_set(c[-2000:], flat, offsets, 12, 1988, 2000).tolist()
                  for _ in range(3)]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert got == [[want.tolist()] * 3] * 2


@pytest.mark.parametrize(
    "n", [0, 7, 8, 1000, (8 << 20) - 1, (8 << 20) + 13, (20 << 20) + 5]
)
def test_hash_matches_apm(n, apm_native):
    # under and over the 8 MB threading stripe: apm's digest depends on the
    # thread count, and both sides take min(16, cpu_count) threads
    buf = _corpus(n, 30) if n < (1 << 20) else np.frombuffer(
        np.random.default_rng(31).bytes(n), np.uint8
    )
    h = native.hash_bytes(buf)
    assert h == apm_native.hash_bytes(buf)
    if n:
        other = buf.copy()
        other[n // 2] ^= 1
        assert native.hash_bytes(other) != h
        assert native.hash_bytes(buf.copy()) == h


def test_read_file_and_range(tmp_path, apm_native):
    from apm_torch.utils.io import read_input_file

    c = _corpus(100_003, 40)
    path = tmp_path / "db.fa"
    c.tofile(path)
    assert np.array_equal(native.read_file(path), c)
    assert np.array_equal(read_input_file(path), c)
    assert np.array_equal(read_input_file(str(path)), apm_native.read_file(str(path)))
    for start, length in ((0, 10), (99_990, 40), (200_000, 5), (5, 0)):
        want = np.zeros(length, np.uint8)
        seg = c[start : start + length]
        want[: len(seg)] = seg
        assert np.array_equal(native.read_range(path, start, length), want)
        assert np.array_equal(apm_native.read_range(str(path), start, length), want)
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    assert native.read_file(empty).size == 0
    with pytest.raises(FileNotFoundError):
        read_input_file(tmp_path / "missing")
    with pytest.raises(ValueError):
        native.read_range(path, -1, 4)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    # no library built for this source yet, and no compiler: the build
    # raises instead of leaving the port to a NumPy path
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        _build.host_build()
    assert not (tmp_path / "build").exists()
    # the CUDA build's sources and key leave the host source out
    assert _build.HOST_SRC not in _build._sources()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "apmio.cpp"
    bad.write_text("int apmio_fold( {\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "HOST_SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\\n)*error"):
        _build.host_build()
    assert list((tmp_path / "build").iterdir()) == []  # no half-built library


def test_no_fallback_when_the_library_fails(monkeypatch):
    import apm_torch
    from apm_torch import ApmConfig

    def broken():
        raise RuntimeError("host library unavailable")

    monkeypatch.setattr(_build, "host_library", broken)
    c = _corpus(20_000, 50)
    with pytest.raises(RuntimeError, match="unavailable"):
        fold_corpus(c, 0, 4, 1024, 128)
    sc = apm_torch.Scanner([b"ACGTACGTAC"], 1, ApmConfig(device="cpu"))
    with pytest.raises(RuntimeError, match="unavailable"):
        sc.count(c)
    with pytest.raises(RuntimeError, match="unavailable"):
        sc.tail_counts(c, len(c) - 9)
