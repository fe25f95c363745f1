"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with a card (and no JAX) run them with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) Counts are
integers: the kernel must equal its plain version exactly.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _corpus(n, seed, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


@pytest.mark.parametrize("k", [0, 1, 3, 16, 17])
def test_dp_kernel_matches_plain(dev, k):
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus, round_up
    from apm_torch.utils.io import PatternSet

    wf, n_rows = 1024, 64
    corpus = _corpus(n_rows * wf + 512, 1 + k)
    pats = [bytes(corpus[100:130]), bytes(corpus[5000:5041]), b"ACGTTGCA"]
    packed, _ = PatternSet.from_patterns(pats).packed(k)
    pat = np.zeros((8, packed.shape[1]), np.uint8)
    pat[:3] = packed
    plens = (30, 41, 8, 0, 0, 0, 0, 0)
    halo = round_up(41 + 2 * k, 128)
    rows = torch.from_numpy(fold_corpus(corpus, 2 * wf, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    kw = dict(k=k, m_max=41, wf=wf, halo=halo, plens=plens)
    bound = 2 * wf + (n_rows - 3) * wf + 333
    before = dp_kernel.LAUNCHES
    got = dp_kernel.scan_folded_dp(rows, dpat, bound, 2 * wf, **kw)
    ref = dp_kernel.scan_folded_dp_ref(rows, dpat, bound, 2 * wf, **kw)
    assert dp_kernel.LAUNCHES == before + 1
    assert got.tolist() == ref.tolist()


@pytest.mark.parametrize(
    "lengths,text,row_off,bound_off",
    [
        ([32, 50], "random", 0, 500),
        ([20] * 40, "random", 0, 500),
        ([70, 80], "random", 0, 500),
        ([1, 3, 7, 97], "random", 0, 500),  # masked prefixes, and m = 97
        ([1, 3, 8, 50, 97], "all-A", 0, 500),  # every window hits
        ([32, 50], "random", 3, 17),  # rows[3:]; the bound ends inside a tile
        ([50] * 64, "random", 0, 500),  # P = 64
    ],
)
def test_corr_kernel_matches_plain(dev, lengths, text, row_off, bound_off):
    from apm_torch.ops import corr_fused
    from apm_torch.ops.corr_engine import build_alphabet
    from apm_torch.ops.common import fold_corpus

    wf, halo, n_rows = 1024, 128, 48
    if text == "all-A":
        corpus = np.full(n_rows * wf + 512, ord("A"), np.uint8)
        pats = [b"A" * m for m in lengths]
    else:
        corpus = _corpus(n_rows * wf + 512, 9)
        pats = [bytes(_corpus(m, 50 + i)) for i, m in enumerate(lengths)]
    step = min(997, (n_rows - 4) * wf // len(pats))
    start = row_off * wf  # the view's first row
    for i, p in enumerate(pats):
        pos = start + 300 + step * i
        corpus[pos : pos + len(p)] = np.frombuffer(p, np.uint8)
    m_max = max(lengths)
    pat_raw = np.zeros((len(pats), m_max), np.uint8)
    for i, p in enumerate(pats):
        pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)
    km, thr = corr_fused.build_fused_tables(pat_raw, lengths, alph)
    tabs = corr_fused.FusedTables.from_numpy(
        km, thr, alph, corr_fused.pick_s(m_max), dev
    )
    staged = torch.from_numpy(fold_corpus(corpus, 0, n_rows + row_off, wf, halo)).to(dev)
    rows = staged[row_off:]
    kw = dict(wf=wf, halo=halo, n_rows=n_rows - 2, p_out=8)
    bound = start + (n_rows - 3) * wf + bound_off
    before = corr_fused.LAUNCHES
    got = corr_fused.scan_corr_fused(rows, tabs, bound, start, **kw)
    ref = corr_fused.scan_corr_fused_ref(rows, tabs, bound, start, **kw)
    assert corr_fused.LAUNCHES == before + 1
    assert got.tolist() == ref.tolist()
    assert int(got.sum()) >= len(pats)
    with pytest.raises(ValueError, match="16-byte"):  # no copy in its stead
        n = rows.shape[0] - 1  # a row short, so the shifted view fits
        flat = staged.reshape(-1)[1 : 1 + n * rows.shape[1]].view(n, rows.shape[1])
        corr_fused.scan_corr_fused(flat, tabs, bound, start, **kw)


@pytest.mark.parametrize("k", [0, 2])
def test_scanner_on_card_matches_oracle(dev, k):
    import apm_torch
    from apm_torch.utils.oracle import count_matches

    c = _corpus(200_000, 3 + k, b"ACGT\n")
    pats = [bytes(c[1000:1050]), bytes(c[7000:7032]), bytes(c[1000:1050])]
    sc = apm_torch.Scanner(pats, k)
    assert sc.count(c).tolist() == count_matches(c, pats, k)


def _tables(pats, k, n_pad=8):
    from apm_torch.ops.common import round_up
    from apm_torch.utils.io import PatternSet

    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    pat = np.zeros((n_pad, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    raw = np.zeros((n_pad, ps.max_len), np.uint8)
    raw[: len(pats)] = ps.table
    plens = tuple(len(p) for p in pats) + (0,) * (n_pad - len(pats))
    return pat, raw, plens, ps.max_len, round_up(ps.max_len + 2 * k, 128)


@pytest.mark.parametrize("k", [1, 3, 8, 14])
def test_myers_kernel_matches_plain_and_band(dev, k):
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows = 1024, 64
    corpus = _corpus(n_rows * wf + 512, 20 + k, b"ACGTN")
    pats = [bytes(corpus[100:130]), bytes(corpus[5000:5050]), b"ACGTTGCAAC"]
    pat, _, plens, m_max, halo = _tables(pats, k)
    alph = tuple(sorted(set(b"".join(pats))))
    rows = torch.from_numpy(fold_corpus(corpus, 2 * wf, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=alph)
    bound = 2 * wf + (n_rows - 3) * wf + 333
    before = (dp_kernel.LAUNCHES, dp_kernel.MYERS_LAUNCHES)
    got = dp_kernel.scan_folded_dp(rows, dpat, bound, 2 * wf, dp_impl="myers", **kw)
    band = dp_kernel.scan_folded_dp(rows, dpat, bound, 2 * wf, dp_impl="band", **kw)
    ref = dp_kernel.scan_folded_myers_ref(rows, dpat, bound, 2 * wf, **kw)
    assert (dp_kernel.LAUNCHES, dp_kernel.MYERS_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert got.tolist() == ref.tolist() == band.tolist()
    assert int(got.sum()) > 0


@pytest.mark.parametrize("dp_impl", ["band", "myers"])
def test_dp_kernels_read_a_device_bound(dev, dp_impl):
    # phase 2 passes min(n_hot, bucket) * wf as a tensor on the card
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows, k = 1024, 32, 3
    corpus = _corpus(n_rows * wf + 512, 31)
    pats = [bytes(corpus[300:332]), bytes(corpus[9000:9050])]
    pat, _, plens, m_max, halo = _tables(pats, k)
    rows = torch.from_numpy(fold_corpus(corpus, 0, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens,
              alphabet=tuple(b"ACGT"), dp_impl=dp_impl)
    for bound in (0, 5 * wf + 17, n_rows * wf - m_max + 1):
        want = dp_kernel.scan_folded_dp(rows, dpat, bound, 0, **kw)
        for dtype in (torch.int32, torch.int64):
            dbound = torch.tensor(bound, dtype=dtype, device=dev)
            got = dp_kernel.scan_folded_dp(rows, dpat, dbound, 0, **kw)
            assert got.tolist() == want.tolist()


@pytest.mark.parametrize(
    "k,lengths,text",
    [
        (0, [12, 20], "random"),
        (0, [3, 7], "random"),  # k = 0 heads under 8 bytes
        (1, [32, 50], "random"),
        (1, [16, 32], "random"),  # 8-byte pieces
        (3, [32, 50], "random"),
        (5, [84, 50], "random"),  # 14-byte exact pieces and the banded tier
        (8, [120, 120], "random"),
        (8, [70, 120], "random"),  # 14-byte banded pieces: 7-byte heads
        (16, [160, 160], "random"),  # start > 0, a mid-row bound, spans of 32
        (1, [32, 16], "all-A"),  # every position hits
        (8, [120], "all-A"),  # the band at every position
    ],
)
def test_filter_kernel_matches_plain(dev, k, lengths, text):
    from apm_torch.ops import filter_kernel
    from apm_torch.ops.common import fold_corpus
    from apm_torch.utils.corpus import plant

    wf, n_rows = 1024, 48
    if text == "all-A":
        corpus = np.full(n_rows * wf + 1024, ord("A"), np.uint8)
        pats = [b"A" * m for m in lengths]
    else:
        corpus = _corpus(n_rows * wf + 1024, 40 + k)
        pats = [bytes(_corpus(m, 60 + i)) for i, m in enumerate(lengths)]
        for i, p in enumerate(pats):
            plant(corpus, np.frombuffer(p, np.uint8), range(200 + 77 * i, len(corpus) - 400, 3001),
                  k=min(k, 3), seed=i)
    _, raw, plens, m_max, halo = _tables(pats, k)
    rows = torch.from_numpy(fold_corpus(corpus, wf, n_rows, wf, halo)).to(dev)
    draw = torch.from_numpy(raw).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
    bound = wf + (n_rows - 5) * wf + 611
    before = filter_kernel.LAUNCHES
    fcnt, rowmap = filter_kernel.scan_filter(rows, draw, bound, wf, **kw)
    rf, rr = filter_kernel.scan_filter_ref(rows, draw, bound, wf, **kw)
    assert filter_kernel.LAUNCHES == before + 1
    assert fcnt.tolist() == rf.tolist()
    assert torch.equal(rowmap, rr)
    assert int(fcnt.sum()) > 0
    if text == "all-A":
        assert fcnt[: len(pats)].tolist() == [bound - wf] * len(pats)


def test_filter_kernel_banded_tier_at_the_capture_panel(dev):
    """The capture panel's layout: 64 probes of 120 bytes at k = 12, each
    seven banded pieces of 17-18 bytes with one error, over rows of 128
    windows and a 256-byte halo; near copies of half the probes planted."""
    from apm_torch.ops import filter_kernel
    from apm_torch.ops.common import fold_corpus
    from apm_torch.utils.corpus import plant

    k, wf, n_rows = 12, 128, 1024
    assert filter_kernel.tier_of(120, k) == (7, 1)
    corpus = _corpus(n_rows * wf + 1024, 120)
    pats = [bytes(_corpus(120, 200 + i)) for i in range(64)]
    for i, p in enumerate(pats[:32]):
        plant(corpus, np.frombuffer(p, np.uint8), range(300 + 997 * i, len(corpus) - 400, 40_009),
              k=3, seed=i)
    _, raw, plens, m_max, halo = _tables(pats, k, n_pad=64)
    assert (m_max, halo) == (120, 256)
    rows = torch.from_numpy(fold_corpus(corpus, 0, n_rows, wf, halo)).to(dev)
    draw = torch.from_numpy(raw).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
    bound = (n_rows - 2) * wf + 77
    before = filter_kernel.LAUNCHES
    fcnt, rowmap = filter_kernel.scan_filter(rows, draw, bound, 0, **kw)
    rf, rr = filter_kernel.scan_filter_ref(rows, draw, bound, 0, **kw)
    assert filter_kernel.LAUNCHES == before + 1
    assert fcnt.tolist() == rf.tolist()
    assert torch.equal(rowmap, rr)
    assert (fcnt[:32] > 0).all()


@pytest.mark.parametrize(
    "wf,k,lengths,text",
    [
        (128, 3, [32, 50], "consecutive"),
        (128, 12, [120, 120, 120, 120], "independent"),  # the capture panel's tier
        (256, 8, [120, 70], "independent"),  # 14-byte banded pieces, 7-byte heads
        (256, 3, [32, 50], "consecutive"),
        (128, 8, [120], "all-A"),  # every owned window a candidate
        (128, 1, [32, 16], "all-A"),
    ],
)
def test_filter_kernel_takes_several_rows_an_item(dev, wf, k, lengths, text):
    """Rows narrower than half a block: an item of several whole rows, each
    read from its own slot. The rows number 3 items and 5 rows, they start
    past window 0, and one bound falls mid-row inside an item that is not
    the last, another inside the last. "independent" rows hold unrelated
    text, planted copies straddling each row's end into its own halo."""
    from apm_torch.ops import filter_kernel
    from apm_torch.ops.common import fold_corpus
    from apm_torch.utils.corpus import plant

    pats = [b"A" * m for m in lengths] if text == "all-A" else [
        bytes(_corpus(m, 500 + i)) for i, m in enumerate(lengths)]
    _, raw, plens, m_max, halo = _tables(pats, k)
    (_, items), = filter_kernel.launch_items(plens, k, wf, halo, filter_kernel.smem_optin(dev))
    assert items.rows > 1 and items.threads == items.rows * wf // 32
    n_rows = 3 * items.rows + 5
    if text == "all-A":
        host = np.full((n_rows, wf + halo), ord("A"), np.uint8)
    elif text == "consecutive":
        corpus = _corpus((n_rows + 2) * wf + halo, 510 + k)
        for i, p in enumerate(pats):
            plant(corpus, np.frombuffer(p, np.uint8), range(50 + 31 * i, len(corpus) - 300, 997),
                  k=min(k, 3), seed=i)
        host = fold_corpus(corpus, 2 * wf, n_rows, wf, halo)
    else:
        host = np.stack([_corpus(wf + halo, 600 + r) for r in range(n_rows)])
        for r in range(n_rows):
            p = np.frombuffer(pats[r % len(pats)], np.uint8)
            # a window near the row's end, its copy in the halo, and another
            plant(host[r], p, [wf - 1 - r % 7, r * 37 % wf], k=min(k, 3), seed=r)
    rows = torch.from_numpy(host).to(dev)
    draw = torch.from_numpy(raw).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
    start = 2 * wf
    for bound in (start + (items.rows + 7) * wf + 61, start + (n_rows - 1) * wf + 3):
        before = filter_kernel.LAUNCHES
        fcnt, rowmap = filter_kernel.scan_filter(rows, draw, bound, start, **kw)
        rf, rr = filter_kernel.scan_filter_ref(rows, draw, bound, start, **kw)
        assert filter_kernel.LAUNCHES == before + 1
        assert fcnt.tolist() == rf.tolist()
        assert torch.equal(rowmap, rr)
        if text == "all-A":
            assert fcnt[: len(pats)].tolist() == [bound - start] * len(pats)
        else:
            assert (rr[:, : len(pats)] > 0).sum() >= 3


def test_filter_kernel_sizes_its_block_to_the_halo(dev):
    # a 64 KB halo leaves room for 64 threads' staging buffers only; at
    # 128 KB not even 32 threads' fit, and the entry refuses the launch
    from apm_torch.ops import filter_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows, k = 8192, 6, 3
    corpus = _corpus(n_rows * wf + (1 << 17), 45)
    pats = [bytes(corpus[500:532]), bytes(corpus[20_000:20_050])]
    _, raw, plens, m_max, _ = _tables(pats, k)
    draw = torch.from_numpy(raw).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=1 << 16, plens=plens)
    rows = torch.from_numpy(fold_corpus(corpus, 0, n_rows, wf, 1 << 16)).to(dev)
    fcnt, rowmap = filter_kernel.scan_filter(rows, draw, n_rows * wf - 100, 0, **kw)
    rf, rr = filter_kernel.scan_filter_ref(rows, draw, n_rows * wf - 100, 0, **kw)
    assert fcnt.tolist() == rf.tolist() and torch.equal(rowmap, rr)
    assert int(fcnt.sum()) >= 2
    kw["halo"] = 1 << 17
    rows = torch.from_numpy(fold_corpus(corpus, 0, n_rows, wf, 1 << 17)).to(dev)
    with pytest.raises(RuntimeError, match="apm_filter_pieces_count"):
        filter_kernel.scan_filter(rows, draw, n_rows * wf - 100, 0, **kw)


@pytest.mark.parametrize("k", [3, 8])
def test_scanner_filtration_on_card_matches_oracle(dev, k):
    import apm_torch
    from apm_torch.ops import dp_kernel, filter_kernel
    from apm_torch.utils.corpus import plant
    from apm_torch.utils.oracle import count_matches

    c = _corpus(300_000, 70 + k, b"ACGT\n")
    lengths = [32, 50] if k == 3 else [120, 120]
    pats = [bytes(_corpus(m, 80 + i)) for i, m in enumerate(lengths)]
    for i, p in enumerate(pats):
        plant(c, np.frombuffer(p, np.uint8), range(1000 + 300 * i, len(c) - 200, 20_000),
              k=3, seed=i)
    before = (filter_kernel.LAUNCHES, dp_kernel.MYERS_LAUNCHES)
    sc = apm_torch.Scanner(pats, k)
    assert sc.count(c).tolist() == count_matches(c, pats, k)
    assert filter_kernel.LAUNCHES > before[0] and dp_kernel.MYERS_LAUNCHES > before[1]


def test_scanner_capture_tail_on_the_worker_matches_reference_and_plain(dev, monkeypatch):
    """The capture panel's shape: 16 probes of 120 bytes at k = 12 over a
    1 MB line, near copies planted in the text, and the first eight probes
    beginning with its last 119 - 7 i bytes, so the EOF-truncated windows
    count. The tail runs on the host worker while kernel D's banded tier
    runs on the card; the counts equal ``benchmark/reference_long.py``'s and
    the plain versions' (``backend="torch"`` on the card)."""
    import threading

    import apm_torch
    from apm_torch import ApmConfig
    from apm_torch.ops import filter_kernel
    from apm_torch.utils import native
    from apm_torch.utils.corpus import plant
    from benchmark import reference_long

    k, n = 12, 1 << 20
    c = _corpus(n, 140)
    probes = [c[n - 119 + 7 * i :].tobytes() + _corpus(1 + 7 * i, 150 + i).tobytes()
              for i in range(8)] + [bytes(_corpus(120, 160 + i)) for i in range(8)]
    for i, p in enumerate(probes):
        plant(c, np.frombuffer(p, np.uint8), range(500 + 4001 * i, n - 2000, 250_007),
              k=4, seed=i)
    real, threads = native.banded_count_set, []

    def spy(*a, **kw):
        threads.append(threading.get_ident())
        return real(*a, **kw)

    monkeypatch.setattr(native, "banded_count_set", spy)
    before = filter_kernel.LAUNCHES
    sc = apm_torch.Scanner(probes, k)
    sc.meter.trace = True
    got = sc.count(c)
    assert filter_kernel.LAUNCHES > before
    assert len(threads) == 1 and threads[0] != threading.get_ident()
    assert sc.meter.last_spans["#tail windows"] == len(probes) * (119 - k)
    want = reference_long.count_many([c], probes, k, dev)[0]
    assert got.tolist() == want.tolist()
    no_eof = reference_long.count_many([c], probes, k, dev, eof=False)[0]
    assert (want[:8] > no_eof[:8]).all()  # the truncated windows count
    plain = apm_torch.Scanner(probes, k, ApmConfig(backend="torch"))
    assert plain.count(c).tolist() == got.tolist()


@pytest.mark.parametrize("chunk_bytes", [None, 1 << 20])
def test_scanner_split_rescan_on_card_matches_plain(dev, chunk_bytes):
    """A 4 MB text at k = 3 with a 32-mer whose 8-byte pieces make most rows
    hot and five sparse 50-mers: the sparse ones are verified on their hot
    rows (kernel C on count_hot_batch), the 32-mer rescanned by kernel C,
    in one chunk or four; the counts equal the plain DP over every window
    and the plain versions on the same route."""
    import apm_torch
    from apm_torch import ApmConfig
    from apm_torch.ops import dp_kernel
    from apm_torch.utils.corpus import plant

    c = _corpus(4 << 20, 90, b"ACGT\n")
    pats = [bytes(_corpus(m, 91 + i)) for i, m in enumerate([32, 50, 50, 50, 50, 50])]
    for i, p in enumerate(pats):
        every = 5_000 if i == 0 else 500_000  # about 800 rows of 1024 against 8
        plant(c, np.frombuffer(p, np.uint8), range(1000 + 300 * i, len(c) - 200, every),
              k=3, seed=i)
    cfg = dict(chunk_bytes=chunk_bytes) if chunk_bytes else {}
    before = dp_kernel.MYERS_LAUNCHES
    sc = apm_torch.Scanner(pats, 3, ApmConfig(**cfg))
    got = sc.count(c).tolist()
    assert sc.last_filtration["route"] == "split-rescan"
    assert sc.last_filtration["sparse"] == [1, 2, 3, 4, 5]
    assert dp_kernel.MYERS_LAUNCHES > before
    plain = apm_torch.Scanner(pats, 3, ApmConfig(backend="torch", **cfg))
    assert plain.count(c).tolist() == got and plain.last_filtration == sc.last_filtration
    every = apm_torch.Scanner(pats, 3, ApmConfig(backend="torch", engine="dp"))
    assert every.count(c).tolist() == got
    assert min(got) > 0


def test_warm_chunk_launches_never_wait_for_the_card(dev, monkeypatch):
    """A warm call at k = 3 over four chunks launches each chunk (kernel D,
    phase 2's compaction and verify) without a host sync: CUDA's sync debug
    mode, set to raise around every launch, lets all four run, and the
    counts are the first call's."""
    import apm_torch
    from apm_torch import ApmConfig
    from apm_torch.utils.corpus import plant

    c = _corpus(4 << 20, 92, b"ACGT\n")
    pats = [bytes(_corpus(m, 93 + i)) for i, m in enumerate([32, 50, 50])]
    for i, p in enumerate(pats):
        plant(c, np.frombuffer(p, np.uint8), range(700 + 300 * i, len(c) - 200, 40_000),
              k=3, seed=i)
    sc = apm_torch.Scanner(pats, 3, ApmConfig(chunk_bytes=1 << 20))
    want = sc.count(c).tolist()
    launch, launched = sc._launch_chunk, []

    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return launch(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            launched.append(args[2])

    monkeypatch.setattr(sc, "_launch_chunk", strict)
    assert sc.count(c).tolist() == want
    assert len(launched) == 4 and min(want) > 0


def _batch_rows(corpora, w, wf, halo, n_slots, bound_of):
    """count_batch's staging of a batch: rows, per-block meta, row limits."""
    from apm_torch.ops.common import fold_corpus

    rows = np.zeros((n_slots * 8, wf + halo), np.uint8)
    meta = np.zeros((n_slots, 2), np.int32)
    limits = np.zeros((n_slots * 8,), np.int32)
    slot = 0
    for c in corpora:
        db = bound_of(len(c))
        for blk in range(-(-db // w) if db > 0 else 0):
            rows[slot * 8 : (slot + 1) * 8] = fold_corpus(c, blk * w, 8, wf, halo)
            meta[slot] = (db, blk * w)
            limits[slot * 8 : (slot + 1) * 8] = np.clip(db - blk * w - np.arange(8) * wf, 0, wf)
            slot += 1
    return rows, meta, limits


@pytest.mark.parametrize("k,dp_impl", [(0, "band"), (1, "band"), (3, "myers"), (12, "myers"), (17, "band")])
def test_dp_batch_kernel_matches_plain(dev, k, dp_impl):
    # TPU kernel #4: the batch mode of kernels A and C
    from apm_torch.ops import dp_kernel

    wf = 1024
    corpora = [_corpus(n, 90 + i) for i, n in enumerate([30_000, 500, 70_000, 9000])]
    pats = [bytes(corpora[0][100:132]), bytes(corpora[2][5000:5050])]
    for c in corpora:
        c[200:250] = np.frombuffer(pats[1], np.uint8)
    pat, _, plens, m_max, halo = _tables(pats, k)
    rows, meta, _ = _batch_rows(corpora, 8 * wf, wf, halo, 20,
                                lambda n: max(0, min(n - m_max + 1, n - k)))
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens,
              alphabet=tuple(b"ACGT"), dp_impl=dp_impl)
    args = (torch.from_numpy(rows).to(dev), torch.from_numpy(pat).to(dev),
            torch.from_numpy(meta).to(dev))
    before = dp_kernel.BATCH_LAUNCHES
    got = dp_kernel.scan_folded_dp_batch(*args, **kw)
    ref = dp_kernel.scan_folded_dp_batch_ref(*args, **kw)
    assert dp_kernel.BATCH_LAUNCHES == before + 1
    assert torch.equal(got, ref)
    assert int(got.sum()) >= 4 and int(got[-1].sum()) == 0


@pytest.mark.parametrize(
    "k,dp_impl,case",
    [(0, "band", "random"), (1, "band", "random"), (3, "myers", "random"),
     (8, "band", "random"),
     (2, "band", "short"), (3, "myers", "short"),  # m < k, m = k, m = m_max
     (16, "band", "random"), (17, "band", "random"),  # registers, then scratch
     (1, "band", "foreign"), (2, "myers", "foreign"),  # NUL and bytes outside ACGT
     (1, "band", "all-A"), (3, "myers", "all-A"),  # every window a hit
     (1, "band", "odd-wf"), (3, "myers", "odd-wf"),  # byte stores, unaligned rows
     (8, "myers", "random"),  # too wide to pack: two chains a thread
     (1, "band", "long"), (1, "band", "long-odd-wf"),  # table past 32 KB: read from global
     (1, "band", "many")],  # patterns over several launches, each table in shared memory
)
def test_dp_mask_kernel_matches_plain(dev, k, dp_impl, case):
    # TPU kernel #6: the mask kernels of csrc/dp_mask.cu, padding slots and
    # a mid-row bound that leaves an odd number of windows owned in its row
    # (a thread's window pair straddles it)
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows = (1023 if case.endswith("odd-wf") else 1024), 40
    alphabet = b"ACGT\x00N\xff" if case == "foreign" else b"ACGT"
    corpus = _corpus(n_rows * wf + 512 + (50_000 if case.startswith("long") else 0), 95 + k, alphabet)
    n_pad = 8
    if case == "long":  # 40 000 bytes: table and stage would pass the 227 KB a block may take
        pats = [bytes(corpus[3000:43000]), b"ACGTTGCAAC"]
    elif case == "long-odd-wf":  # 9000 bytes, the last pair of a row half past its end
        pats = [bytes(corpus[3000:12000]), b"ACGTTGCAAC"]
    elif case == "many":  # 200 patterns of 50 bytes: 157 fit a 32 KB table
        pats = [bytes(corpus[q : q + 50]) for q in range(1000, 1000 + 200 * 97, 97)]
        n_pad = 202
    elif case == "all-A":
        corpus[:] = ord("A")
        pats = [b"A" * 40, b"A" * 12, b"A" * (k + 1)]
    elif case == "short":
        pats = [bytes(corpus[3000 : 3000 + m]) for m in (k - 1, k, 12)]
    elif case == "foreign":  # ACGT patterns planted in the foreign text
        pats = [bytes(_corpus(40, 7)), bytes(_corpus(12, 8)), b"ACGTTGCAAC"]
        corpus[3000:3040] = np.frombuffer(pats[0], np.uint8)
        corpus[7000:7012] = np.frombuffer(pats[1], np.uint8)
    else:
        pats = [bytes(corpus[3000:3040]), bytes(corpus[7000:7012]), b"ACGTTGCAAC"]
    pat, _, plens, m_max, halo = _tables(pats, k, n_pad)
    rows = torch.from_numpy(fold_corpus(corpus, wf, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens,
              alphabet=tuple(b"ACGT"), dp_impl=dp_impl)
    assert dp_kernel._is_myers(k, m_max, plens, tuple(b"ACGT"), dp_impl) == (dp_impl == "myers")
    bound = wf + (n_rows - 4) * wf + 333
    launches = 1 if dp_impl == "myers" else -(-n_pad // dp_kernel._table_group(pat.shape[1]))
    assert launches == (2 if case == "many" else 1)
    before = dp_kernel.MASK_LAUNCHES
    counts, mask = dp_kernel.scan_folded_dp_mask(rows, dpat, bound, wf, **kw)
    rc, rm = dp_kernel.scan_folded_dp_mask_ref(rows, dpat, bound, wf, **kw)
    assert dp_kernel.MASK_LAUNCHES == before + launches
    assert torch.equal(counts, rc) and torch.equal(mask, rm)
    assert int(counts.sum()) >= 2 and int(mask[n_rows - 3 :].sum()) == 0
    if case == "all-A":  # every owned window of every real pattern
        assert counts[:3].tolist() == [bound - wf] * 3
    dbound = torch.tensor(bound, device=dev)
    c2, m2 = dp_kernel.scan_folded_dp_mask(rows, dpat, dbound, wf, **kw)
    assert torch.equal(c2, rc) and torch.equal(m2, rm)


@pytest.mark.parametrize(
    "lengths,text",
    [([32, 50], "random"), ([20] * 40, "random"), ([70, 80], "random"),
     ([1, 3, 7], "random"),  # masked prefixes
     ([1, 3, 8, 50], "all-A")],  # every window hits
)
def test_corr_batch_kernel_matches_plain(dev, lengths, text):
    # TPU kernel #8: the batch mode of kernel B, per-row limits
    from apm_torch.ops import corr_fused
    from apm_torch.ops.corr_engine import build_alphabet

    wf, halo = 1024, 128
    sizes = [40_000, 700, 20_000]
    if text == "all-A":
        pats = [b"A" * m for m in lengths]
        corpora = [np.full(n, ord("A"), np.uint8) for n in sizes]
    else:
        pats = [bytes(_corpus(m, 50 + i)) for i, m in enumerate(lengths)]
        corpora = [_corpus(n, 99 + i) for i, n in enumerate(sizes)]
    for i, p in enumerate(pats):
        c = corpora[i % 3]
        at = (997 * i) % (len(c) - len(p))
        c[at : at + len(p)] = np.frombuffer(p, np.uint8)
    m_max = max(lengths)
    pat_raw = np.zeros((len(pats), m_max), np.uint8)
    for i, p in enumerate(pats):
        pat_raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)
    km, thr = corr_fused.build_fused_tables(pat_raw, lengths, alph)
    tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, corr_fused.pick_s(m_max), dev)
    rows, _, limits = _batch_rows(corpora, 8 * wf, wf, halo, 12, lambda n: n - m_max + 1)
    args = (torch.from_numpy(rows).to(dev), tabs, torch.from_numpy(limits).to(dev))
    kw = dict(wf=wf, halo=halo, p_out=48)
    before = corr_fused.BATCH_LAUNCHES
    got = corr_fused.scan_corr_batch_fused(*args, **kw)
    ref = corr_fused.scan_corr_batch_fused_ref(*args, **kw)
    assert corr_fused.BATCH_LAUNCHES == before + 1
    assert torch.equal(got, ref)
    assert int(got.sum()) >= min(3, len(pats))  # plants may overwrite each other
    if text == "all-A":  # every owned window matches every A^m
        assert got[:, : len(pats)].sum(0).tolist() == [int(limits.sum())] * len(pats)
    with pytest.raises(ValueError, match="16-byte"):  # no copy in its stead
        d = args[0]
        n = d.shape[0] - 8
        flat = d.reshape(-1)[1 : 1 + n * d.shape[1]].view(n, d.shape[1])
        corr_fused.scan_corr_batch_fused(flat, tabs, args[2][:n], **kw)


@pytest.mark.parametrize("k", [0, 1, 3])
def test_count_batch_on_card_matches_oracle(dev, k):
    import apm_torch
    from apm_torch.ops import corr_fused, dp_kernel
    from apm_torch.utils.oracle import count_matches

    pats = [bytes(_corpus(50, 110)), bytes(_corpus(32, 111))]
    corpora = [_corpus(n, 112 + i, b"ACGT\n") for i, n in enumerate([200_000, 30, 0, 70_000, 3000])]
    for c in (corpora[0], corpora[3]):
        c[1000:1050] = np.frombuffer(pats[0], np.uint8)
    before = (corr_fused.BATCH_LAUNCHES, dp_kernel.BATCH_LAUNCHES)
    sc = apm_torch.Scanner(pats + pats[:1], k, apm_torch.ApmConfig(batch_blocks=8))
    got = sc.count_batch(corpora)
    for b, c in enumerate(corpora):
        assert got[b].tolist() == count_matches(c, pats + pats[:1], k)
    after = (corr_fused.BATCH_LAUNCHES, dp_kernel.BATCH_LAUNCHES)
    assert after[0 if k == 0 else 1] > before[0 if k == 0 else 1]


@pytest.mark.parametrize("k", [1, 2])
def test_find_on_card_matches_oracle(dev, k):
    import apm_torch
    from apm_torch.ops import dp_kernel, filter_kernel
    from apm_torch.utils.corpus import plant
    from apm_torch.utils.oracle import banded_distances

    c = _corpus(300_000, 120 + k, b"ACGT\n")
    pats = [bytes(_corpus(50, 121)), bytes(_corpus(9, 122))]  # filter path, dense sweep
    plant(c, np.frombuffer(pats[0], np.uint8), range(500, len(c) - 100, 7001), k=k, seed=k)
    before = (filter_kernel.LAUNCHES, dp_kernel.MASK_LAUNCHES)
    sc = apm_torch.Scanner(pats, k)
    got = sc.find(c)
    for pi, p in enumerate(pats):
        assert got[pi].tolist() == np.nonzero(banded_distances(c, p, k) <= k)[0].tolist()
    assert filter_kernel.LAUNCHES > before[0] and dp_kernel.MASK_LAUNCHES > before[1]


@pytest.mark.parametrize(
    "k,lengths,text,row_off",
    [
        (1, [32, 50, 50], "random", 0),
        (2, [32, 50, 50], "random", 0),
        (4, [32, 50, 50], "random", 0),
        (1, [20] * 17, "random", 0),
        (1, [1, 3, 7, 16, 17, 65], "random", 0),  # 8- and 9-byte pieces, m = 65
        (1, [32, 50], "all-A", 0),  # every position hits
        (2, [32, 50, 50], "random", 3),  # rows[3:]
        (1, [50] * 64, "random", 0),  # P = 64, 128 pieces
    ],
)
def test_pieces_kernel_matches_plain(dev, k, lengths, text, row_off):
    # TPU kernel #7: the fused piece scan, fcnt and rowmap cell for cell
    from apm_torch.ops import corr_fused
    from apm_torch.ops.common import fold_corpus
    from apm_torch.ops.corr_engine import build_alphabet
    from apm_torch.ops.filter_kernel import tier_of
    from apm_torch.utils.corpus import plant

    wf, halo, n_rows = 1024, 128, 48
    if text == "all-A":
        corpus = np.full(n_rows * wf + 2048, ord("A"), np.uint8)
        pats = [b"A" * m for m in lengths]
    else:
        corpus = _corpus(n_rows * wf + 2048, 130 + k)
        pats = [bytes(_corpus(m, 140 + i)) for i, m in enumerate(lengths)]
        for i, p in enumerate(pats):
            plant(corpus, np.frombuffer(p, np.uint8), range(300 + 97 * i, len(corpus) - 200, 5003),
                  k=k, seed=i)
    _, raw, _, _, _ = _tables(pats, k, n_pad=-(-len(pats) // 8) * 8)
    plens = tuple(len(p) if tier_of(len(p), k) else 0 for p in pats)
    plens += (0,) * (raw.shape[0] - len(pats))
    alph = build_alphabet(pats)
    km, thr, owner64 = corr_fused.build_fused_piece_tables(raw, plens, k, alph)
    tabs = corr_fused.PieceTables.from_numpy(km, thr, owner64, alph, dev)
    staged = torch.from_numpy(fold_corpus(corpus, wf, n_rows + row_off, wf, halo)).to(dev)
    rows = staged[row_off:]
    kw = dict(wf=wf, halo=halo, n_rows=n_rows - 2)
    bound = wf + (n_rows - 5) * wf + 611
    before = corr_fused.PIECE_LAUNCHES
    fcnt, rowmap = corr_fused.scan_pieces_fused(rows, tabs, bound, wf, **kw)
    rf, rr = corr_fused.scan_pieces_fused_ref(rows, tabs, bound, wf, **kw)
    assert corr_fused.PIECE_LAUNCHES == before + len(tabs.groups)
    assert torch.equal(fcnt, rf) and torch.equal(rowmap, rr)
    assert int(fcnt.sum()) > 0 and int(rowmap[n_rows - 4 :].sum()) == 0
    with pytest.raises(ValueError, match="16-byte"):  # no copy in its stead
        n = rows.shape[0] - 1  # a row short, so the shifted view fits
        flat = staged.reshape(-1)[1 : 1 + n * rows.shape[1]].view(n, rows.shape[1])
        corr_fused.scan_pieces_fused(flat, tabs, bound, wf, **kw)


@pytest.mark.parametrize("k", [0, 1, 3, 20])
def test_dyn_kernel_matches_plain_and_band(dev, k):
    # TPU kernel #9: the band with the lengths in device memory, two length
    # vectors through the same tensor, a device start and bound
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows = 1024, 64
    corpus = _corpus(n_rows * wf + 512, 150 + k)
    pats = [bytes(corpus[100:130]), bytes(corpus[5000:5041]), b"ACGTTGCA", bytes(corpus[9000:9012])]
    pat, _, plens, m_max, halo = _tables(pats, k)
    rows = torch.from_numpy(fold_corpus(corpus, 2 * wf, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    bound = 2 * wf + (n_rows - 3) * wf + 333
    dplen = torch.zeros((8,), dtype=torch.int32, device=dev)
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo)
    for lens in (plens, (0, 41, 8, 0, 12, 0, 0, 0)):
        dplen.copy_(torch.tensor(lens, dtype=torch.int32))
        before = dp_kernel.DYN_LAUNCHES
        got = dp_kernel.scan_folded(rows, dpat, dplen, torch.tensor(bound, device=dev),
                                    torch.tensor(2 * wf, device=dev), **kw)
        assert dp_kernel.DYN_LAUNCHES == before + 1
        ref = dp_kernel.scan_folded_ref(rows, dpat, dplen, bound, 2 * wf, **kw)
        band = dp_kernel.scan_folded_dp(rows, dpat, bound, 2 * wf, plens=tuple(lens), **kw)
        assert got.tolist() == ref.tolist() == band.tolist()
        assert int(got.sum()) > 0


def test_entry_on_card_matches_plain_and_oracle(dev):
    from apm_torch import graft_entry
    from apm_torch.ops import dp_kernel
    from apm_torch.utils.oracle import banded_distances

    fn, args = graft_entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    got = fn(*args)
    assert got.shape == (8,) and got.dtype == torch.int32
    ref = dp_kernel.scan_folded_ref(*args, k=graft_entry.K, m_max=12,
                                    wf=graft_entry.W // 8, halo=128)
    corpus = graft_entry.example_corpus()
    bound = int(args[3])
    owned = [int((banded_distances(corpus, p, graft_entry.K)[:bound] <= graft_entry.K).sum())
             for p in graft_entry.PATTERNS]
    assert got.tolist() == ref.tolist() and got.tolist()[:2] == owned and sum(owned) > 0


@pytest.mark.parametrize("k", [1, 2])
def test_scanner_fused_phase1_on_card_matches_oracle(dev, k):
    import apm_torch
    from apm_torch.ops import corr_fused
    from apm_torch.utils.corpus import plant
    from apm_torch.utils.oracle import count_matches

    c = _corpus(300_000, 160 + k, b"ACGT\n")
    pats = [bytes(_corpus(32, 161)), bytes(_corpus(50, 162))]
    plant(c, np.frombuffer(pats[1], np.uint8), range(1000, len(c) - 200, 20_000), k=k, seed=k)
    before = corr_fused.PIECE_LAUNCHES
    sc = apm_torch.Scanner(pats, k, apm_torch.ApmConfig(corr_impl="fused"))
    assert sc.count(c).tolist() == count_matches(c, pats, k)
    assert corr_fused.PIECE_LAUNCHES > before


@pytest.mark.parametrize("lengths,cfg", [([32, 50], dict(corr_impl="conv")), ([120, 20], {})])
def test_scanner_conv_k0_on_card_matches_oracle(dev, lengths, cfg):
    import apm_torch
    from apm_torch.utils.oracle import count_matches

    c = _corpus(200_000, 170, b"ACGT\n")
    pats = [bytes(_corpus(m, 171 + i)) for i, m in enumerate(lengths)]
    for i, p in enumerate(pats):
        for pos in range(500 + 77 * i, len(c) - 200, 30_011):
            c[pos : pos + len(p)] = np.frombuffer(p, np.uint8)
    sc = apm_torch.Scanner(pats, 0, apm_torch.ApmConfig(**cfg))
    assert sc.count(c).tolist() == count_matches(c, pats, 0)
    corpora = [c[:70_000], c[70_000:70_100], c[100_000:]]
    got = sc.count_batch(corpora)
    assert [g.tolist() for g in got] == [count_matches(x, pats, 0) for x in corpora]


@pytest.mark.parametrize(
    "k,dp_impl,case",
    [(0, "band", "random"), (1, "band", "random"), (3, "band", "random"),
     (3, "myers", "random"), (7, "myers", "random"),  # the widest packed Myers band
     (8, "myers", "random"), (12, "myers", "random"),  # two chains a thread
     (16, "band", "random"), (17, "band", "random"),  # registers, then scratch
     (1, "band", "odd-wf"), (3, "myers", "odd-wf"),  # wf % 512 != 0: a partial last tile
     (1, "band", "all-A"), (3, "myers", "all-A"),  # two hits a thread
     (1, "band", "foreign"), (2, "myers", "foreign"),  # NUL and bytes outside ACGT
     (1, "band", "long")],  # a 40 000-byte pattern: table past 32 KB, read from global
)
def test_dp_pair_count_kernels_match_plain(dev, k, dp_impl, case):
    # kernels A and C on csrc/dp_pair.cuh's tile walk, in count, batch and
    # (band) dynamic-length mode: start and bound mid-row, an odd number of
    # windows owned in the bound's row (a thread's pair straddles it), a
    # bound in device memory, per-block batch limits of 0, odd and whole
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows = (1000 if case == "odd-wf" else 1024), 40
    alphabet = b"ACGT\x00N\xff" if case == "foreign" else b"ACGT"
    corpus = _corpus(n_rows * wf + 512 + (50_000 if case == "long" else 0), 400 + k, alphabet)
    if case == "long":
        pats = [bytes(corpus[3000:43000]), b"ACGTTGCAAC"]
    elif case == "all-A":
        corpus[:] = ord("A")
        pats = [b"A" * 40, b"A" * 12, b"A" * (k + 1)]
    elif case == "foreign":
        pats = [bytes(_corpus(40, 7)), bytes(_corpus(12, 8)), b"ACGTTGCAAC"]
        corpus[3000:3040] = np.frombuffer(pats[0], np.uint8)
        corpus[7000:7012] = np.frombuffer(pats[1], np.uint8)
    else:
        pats = [bytes(corpus[3000:3040]), bytes(corpus[7000:7012]), b"ACGTTGCAAC"]
    pat, _, plens, m_max, halo = _tables(pats, k)
    rows = torch.from_numpy(fold_corpus(corpus, wf, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    alph = tuple(b"ACGT")
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=alph, dp_impl=dp_impl)
    assert dp_kernel._is_myers(k, m_max, plens, alph, dp_impl) == (dp_impl == "myers")
    bound = wf + (n_rows - 4) * wf + 333
    ref = dp_kernel.scan_folded_dp_ref(rows, dpat, bound, wf, k=k, m_max=m_max, wf=wf,
                                       halo=halo, plens=plens)
    for b in (bound, torch.tensor(bound, device=dev)):
        got = dp_kernel.scan_folded_dp(rows, dpat, b, wf, **kw)
        assert got.tolist() == ref.tolist()
    assert int(ref.sum()) >= 2
    if case == "all-A":  # every owned window of every real pattern
        assert ref[:3].tolist() == [bound - wf] * 3
    # batch mode: per-block [bound, start] pairs over the same rows
    limits = [0, 3 * wf + 77, 8 * wf, 5 * wf + 1, 2 * wf]
    meta = torch.tensor([[b * 8 * wf + lim, b * 8 * wf] for b, lim in enumerate(limits)],
                        dtype=torch.int32, device=dev)
    before = dp_kernel.BATCH_LAUNCHES
    got = dp_kernel.scan_folded_dp_batch(rows, dpat, meta, **kw)
    assert dp_kernel.BATCH_LAUNCHES == before + 1
    want = dp_kernel.scan_folded_dp_batch_ref(rows, dpat, meta, **kw)
    assert torch.equal(got, want) and int(got[0].sum()) == 0
    if dp_impl == "band":  # kernel #9: lengths outside [1, m_max] count nothing
        lens = (plens[0], m_max + 1, plens[2] if len(pats) > 2 else 0, -1, 0, 0, 0, 0)
        dplen = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = dp_kernel.scan_folded(rows, dpat, dplen, torch.tensor(bound, device=dev),
                                    torch.tensor(wf, device=dev), k=k, m_max=m_max, wf=wf, halo=halo)
        live = torch.tensor([max(m, 0) if m <= m_max else 0 for m in lens], dtype=torch.int32)
        want = dp_kernel.scan_folded_ref(rows, dpat, live.to(dev), bound, wf, k=k, m_max=m_max,
                                         wf=wf, halo=halo)
        assert got.tolist() == want.tolist()


@pytest.mark.parametrize("k", [16382, 20000])
def test_dp_band_count_past_16_bit_cells(dev, k):
    # k + 1 past the paired cells' 16 bits with m_max <= 16 (the register
    # path): D[m][m] <= m <= k, so every owned window of a live pattern
    # counts, as the plain band says for any k >= m
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows = 1024, 16
    corpus = _corpus(n_rows * wf + 512, 7)
    pats = [bytes(corpus[100:112]), b"ACGTTGCA"]
    pat, _, plens, m_max, halo = _tables(pats, k)
    rows = torch.from_numpy(fold_corpus(corpus, 0, n_rows, wf, halo)).to(dev)
    bound = (n_rows - 2) * wf + 77
    got = dp_kernel.scan_folded_dp(rows, torch.from_numpy(pat).to(dev), bound, 0, k=k,
                                   m_max=m_max, wf=wf, halo=halo, plens=plens)
    assert got.tolist() == [bound, bound] + [0] * 6


@pytest.mark.parametrize("k", [16382, 20000])
def test_dp_band_mask_past_16_bit_cells(dev, k):
    # the mask entry of kernel #6 at the same k: the register path decides
    # at k' = 16382, and every owned window of a live pattern is a 1 in the
    # mask, byte for byte the plain mask mode's
    from apm_torch.ops import dp_kernel
    from apm_torch.ops.common import fold_corpus

    wf, n_rows = 1024, 40
    corpus = _corpus(n_rows * wf + 512, 8)
    pats = [bytes(corpus[100:116]), b"ACGTTGCA"]
    pat, _, plens, m_max, halo = _tables(pats, k)
    rows = torch.from_numpy(fold_corpus(corpus, 0, n_rows, wf, halo)).to(dev)
    dpat = torch.from_numpy(pat).to(dev)
    bound = (n_rows - 3) * wf + 77
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, dp_impl="band")
    before = dp_kernel.MASK_LAUNCHES
    counts, mask = dp_kernel.scan_folded_dp_mask(rows, dpat, bound, 0, **kw)
    assert dp_kernel.MASK_LAUNCHES == before + 1
    rc, rm = dp_kernel.scan_folded_dp_mask_ref(rows, dpat, bound, 0, **kw)
    assert counts.tolist() == rc.tolist() == [bound, bound] + [0] * 6
    assert torch.equal(mask, rm)


@pytest.mark.parametrize("k", [16383, 20000])
def test_find_past_16_bit_cells(dev, k):
    # Scanner.find at such k: the kernels' positions equal the plain
    # versions' on the card, every window start below n - k
    import apm_torch

    n = k + 300_000
    c = _corpus(n, 9)
    pats = [bytes(c[500:512]), b"ACGTTGCA"]
    got = apm_torch.Scanner(pats, k, apm_torch.ApmConfig(device="cuda")).find(c)
    plain = apm_torch.Scanner(pats, k, apm_torch.ApmConfig(device="cuda", backend="torch")).find(c)
    assert [p.tolist() for p in got] == [p.tolist() for p in plain]
    assert all(p.tolist() == list(range(n - k)) for p in got)
