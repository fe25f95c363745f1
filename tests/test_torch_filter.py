"""Kernel D's plain version against apm's shift-OR filtration kernel.

``scan_filter_ref`` (and the ``scan_filter`` wrapper, which takes it for CPU
tensors) must give exactly the ``(fcnt, rowmap)`` of
``apm.ops.filter_kernel.scan_filter_pallas(..., interpret=True)`` on the same
staged rows: candidate totals and per-row candidate counts, cell for cell.
Both are integers: tolerance 0. The CUDA kernel itself is compared with the
same plain version on the card (``chip_smoke.py`` phase 3b,
``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from apm_torch.ops import filter_kernel
from apm_torch.ops.common import fold_corpus, round_up
from apm_torch.utils.corpus import plant
from apm_torch.utils.io import PatternSet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WF = 256


def _setup(lengths, k, n_rows, seed, start_row=0, alphabet=b"ACGT", n_pad=8):
    """Staged rows of a corpus with planted (k-substituted) copies of each
    pattern, the raw pattern table padded to n_pad slots, and the static
    lengths (0 for slots filtration does not take)."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    corpus = a[rng.integers(0, len(a), (start_row + n_rows) * WF + 512)]
    pats = []
    for i, m in enumerate(lengths):
        p = a[rng.integers(0, len(a), m)]
        plant(corpus, p, range(37 + 53 * i, len(corpus) - 300, 331), k=min(k, 3),
              seed=seed + i)
        pats.append(p.tobytes())
    ps = PatternSet.from_patterns(pats)
    raw = np.zeros((n_pad, ps.max_len), np.uint8)
    raw[: len(pats)] = ps.table
    plens = tuple(m if filter_kernel.filter_eligible(m, k) else 0 for m in lengths)
    plens += (0,) * (n_pad - len(lengths))
    halo = round_up(ps.max_len + 2 * k, 128)
    rows = fold_corpus(corpus, start_row * WF, n_rows, WF, halo)
    return rows, raw, plens, ps.max_len, halo


def _apm(rows, raw, bound, start, k, m_max, halo, plens):
    import jax.numpy as jnp

    from apm.ops.filter_kernel import scan_filter_pallas

    fcnt, rowmap = scan_filter_pallas(
        jnp.asarray(rows), jnp.asarray(raw),
        jnp.asarray(bound, jnp.int32), jnp.asarray(start, jnp.int32),
        k=k, m_max=m_max, wf=WF, halo=halo, plens=plens, interpret=True,
    )
    return np.asarray(fcnt), np.asarray(rowmap)


def _port(rows, raw, bound, start, k, m_max, halo, plens):
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens)
    r, p = torch.from_numpy(rows), torch.from_numpy(raw)
    before = filter_kernel.LAUNCHES
    fcnt, rowmap = filter_kernel.scan_filter_ref(r, p, bound, start, **kw)
    wf, wr = filter_kernel.scan_filter(r, p, bound, start, **kw)
    assert filter_kernel.LAUNCHES == before  # CPU tensors never launch
    assert fcnt.dtype == rowmap.dtype == torch.int32
    assert fcnt.shape == (raw.shape[0],) and rowmap.shape == (rows.shape[0], raw.shape[0])
    assert torch.equal(fcnt, wf) and torch.equal(rowmap, wr)
    return fcnt.numpy(), rowmap.numpy()


def _check(rows, raw, bound, start, k, m_max, halo, plens):
    want = _apm(rows, raw, bound, start, k, m_max, halo, plens)
    got = _port(rows, raw, bound, start, k, m_max, halo, plens)
    assert got[0].tolist() == want[0].tolist()
    assert np.array_equal(got[1], want[1])
    return got


@pytest.mark.parametrize(
    "k,lengths,tiers",
    [
        (0, [12, 20], {(1, 0)}),  # k = 0: candidates are exact matches
        (1, [32, 50], {(2, 0)}),
        (3, [32, 50], {(4, 0)}),
        (5, [84, 50, 40], {(6, 0), (3, 1)}),  # both tiers and an ineligible slot
        (8, [120, 120], {(5, 1)}),
        (16, [160, 170], {(9, 1)}),
    ],
)
def test_filter_ref_matches_apm(k, lengths, tiers):
    n_rows = 16
    rows, raw, plens, m_max, halo = _setup(lengths, k, n_rows, seed=10 + k)
    assert {filter_kernel.tier_of(m, k) for m in plens if m} == tiers
    bound = n_rows * WF - m_max + 1
    fcnt, rowmap = _check(rows, raw, bound, 0, k, m_max, halo, plens)
    assert fcnt[: len(lengths)].sum() > 0
    assert (rowmap.sum(axis=0) == fcnt).all()
    if k == 0:  # candidates are the exact matches of each owned window
        for p, m in enumerate(lengths):
            wins = np.lib.stride_tricks.sliding_window_view(rows, m, axis=1)[:, :WF]
            hit = (wins == raw[p, :m]).all(axis=2).reshape(-1)[:bound]
            assert fcnt[p] == hit.sum()


def test_filter_ref_start_and_mid_row_bound():
    k, n_rows, start_row = 3, 16, 5
    rows, raw, plens, m_max, halo = _setup([32, 50, 9], k, n_rows, seed=40,
                                           start_row=start_row)
    assert plens[2] == 0  # m = 9 at k = 3 is not filtration-eligible
    start = start_row * WF
    bound = start + 9 * WF + 101  # row 9 owns 101 windows, rows past it none
    fcnt, rowmap = _check(rows, raw, bound, start, k, m_max, halo, plens)
    assert not rowmap[10:].any() and rowmap[:9].any()


@pytest.mark.parametrize("k", [1, 5])
def test_filter_ref_full_byte_range(k):
    # text and patterns over all 256 byte values: the 256 sentinel of the
    # padded table must never equal a text byte (0xFF included)
    alphabet = bytes(range(256))
    lengths = [40, 90] if k == 1 else [84, 60]
    rows, raw, plens, m_max, halo = _setup(lengths, k, 8, seed=50 + k,
                                           alphabet=alphabet)
    assert all(plens[: len(lengths)])
    rows[2, 10:20] = 0xFF
    bound = 8 * WF - m_max + 1
    fcnt, _ = _check(rows, raw, bound, 0, k, m_max, halo, plens)
    assert fcnt[: len(lengths)].sum() > 0


def test_filter_wrapper_checks_its_inputs():
    k = 1
    rows, raw, plens, m_max, halo = _setup([32], k, 8, seed=60)
    r, p = torch.from_numpy(rows), torch.from_numpy(raw)
    kw = dict(k=k, m_max=m_max, wf=WF, halo=halo, plens=plens)
    with pytest.raises(ValueError):
        filter_kernel.scan_filter(r.to(torch.int32), p, 100, 0, **kw)
    with pytest.raises(ValueError):  # halo below m_max + 2k
        filter_kernel.scan_filter(r[:, :-100], p, 100, 0, **{**kw, "halo": halo - 100})
    with pytest.raises(ValueError):  # a length filtration does not take
        filter_kernel.scan_filter(r, p, 100, 0, **{**kw, "plens": (9,) + plens[1:]})
    with pytest.raises(ValueError):
        filter_kernel.scan_filter(r, p[:, 1:], 100, 0, **kw)


def test_piece_plan_lists_every_piece_with_its_shifts():
    plens = (84, 50, 0, 0)
    k = 5
    pieces, pstart, span = filter_kernel.piece_plan(plens, k)
    assert pstart.tolist() == [0, 6, 9, 9, 9]  # 6 exact pieces, 3 banded, two padding slots
    rows = []
    for m in (84, 50):
        j, kp = filter_kernel.tier_of(m, k)
        for idx, (o, li) in enumerate(filter_kernel.pieces_of_j(m, j)):
            rows.append((o, li, kp) + filter_kernel.piece_shift_range(idx, j, o, li, m, k, kp))
    assert [tuple(r) for r in pieces.tolist()] == rows
    assert span == max(r[4] - r[3] for r in rows)
    assert filter_kernel.sentinel_pad(plens, k) == 1
    table = filter_kernel.pchar_table(torch.zeros((4, 84), dtype=torch.uint8), 1)
    assert table.shape == (4, 87) and int(table[0, 0]) == filter_kernel.SENTINEL


# -- kernel D's design, modelled in NumPy ---------------------------------------
#
# The CUDA kernel cannot run here, so its algorithm is held to the plain
# version and to apm through a NumPy model that takes the same steps: the
# head word of every piece (piece_layout's bytes, packed in prefix_words'
# order) at every position a window reaches, the rest of the piece (exact
# tier) or, after the half-split test of the head and tail words, the band
# (banded tier) on the survivors only, then the OR of the hits over the
# shift span.


def _words(pat, piece):
    """The head and tail words of a piece_layout row over the pattern's
    bytes ``pat``, each as int32 (word lo, hi, mask lo, hi)."""
    from apm_torch.ops.corr_fused import prefix_words

    o, li, n_head, n_tail = (int(piece[i]) for i in (4, 2, 6, 7))
    out = []
    for first, n in ((o, n_head), (o + li - n_tail, n_tail)):
        word = prefix_words(np.asarray(pat[first : first + n], np.uint8)[None], [n])
        out.append(word.view("<u4").reshape(4).view(np.int32))
    return out


def _word_test(rows, x0, n, cols):
    """(R, n) bool: the 8 bytes at columns x0 .. x0 + n - 1 (zero past the
    row) equal word cols[0:2] under mask cols[2:4], little-endian."""
    r, w = rows.shape
    padded = np.zeros((r, max(w, x0 + n) + 8), np.uint8)
    padded[:, :w] = rows
    words = np.ascontiguousarray(
        np.lib.stride_tricks.sliding_window_view(padded, 8, axis=1)[:, x0 : x0 + n]
    ).view("<u8")[..., 0]
    word, mask = np.asarray(cols, np.int32).view("<u8")
    return ((words ^ word) & mask) == 0


def _band(text, t0, pc, li):
    """Kernel D's hit_banded: the pinned-start width-3 band of the piece
    whose sentinel-padded chars are pc[1:] (pc[0] the front sentinel) over
    text from t0."""
    inf = filter_kernel.INF
    b0, b1, b2, cap = inf, 0, 1, inf
    for t in range(1, li + 2):
        c = int(text[t0 + t - 1]) if t0 + t - 1 < len(text) else 0
        n0 = min(b0 + (c != pc[t - 1]), b1 + 1)
        n1 = min(b1 + (c != pc[t]), b2 + 1, n0 + 1)
        n2 = min(b2 + (c != pc[t + 1]), n1 + 1)
        b0, b1, b2 = n0, n1, n2
        if t == li - 1:
            cap = b2
        elif t == li:
            cap = min(cap, b1)
        elif t == li + 1:
            cap = min(cap, b0)
        if min(b0, b1, b2) > 1:
            break
    return cap <= 1


def _half_split(rows, x0, n, piece, pat):
    """(R, n) bool: the banded tier's necessary test at positions x0 + i:
    the head word there, or the tail word at drift -1, 0 or +1."""
    head, tail_word = _words(pat, piece)
    tail = _word_test(rows, x0 + int(piece[5]), n + 2, tail_word)
    return _word_test(rows, x0, n, head) | tail[:, :n] | tail[:, 1 : n + 1] | tail[:, 2:]


def _model(rows, raw, bound, start, k, plens):
    table, pstart = filter_kernel.piece_layout(plens, k)
    pad = filter_kernel.sentinel_pad(plens, k)
    pchar = filter_kernel.pchar_table(torch.from_numpy(raw), pad).numpy()
    n_rows, width = rows.shape
    text = np.zeros((n_rows, width + 64), np.uint8)
    text[:, :width] = rows
    own = np.arange(WF)[None, :] < np.clip(bound - start - np.arange(n_rows) * WF, 0, WF)[:, None]
    rowmap = np.zeros((n_rows, len(plens)), np.int32)
    for p in range(len(plens)):
        cand = np.zeros((n_rows, WF), bool)
        for piece in table[pstart[p] : pstart[p + 1]]:
            off, span, li, kp, o = (int(v) for v in piece[:5])
            n = WF + span  # positions off .. off + WF + span - 1
            if kp == 0:
                head = _word_test(rows, off, n, _words(raw[p], piece)[0])
                wins = np.lib.stride_tricks.sliding_window_view(text, li, axis=1)[:, off : off + n]
                hit = head & (wins[:, :, 8:] == raw[p, o + 8 : o + li]).all(axis=2)
            else:
                hit = np.zeros((n_rows, n), bool)
                pc = pchar[p, pad + o - 1 :]
                for r, i in zip(*np.nonzero(_half_split(rows, off, n, piece, raw[p]))):
                    hit[r, i] = _band(text[r], off + i, pc, li)
            for s in range(span + 1):
                cand |= hit[:, s : s + WF]
        rowmap[:, p] = (cand & own).sum(axis=1)
    return rowmap.sum(axis=0).astype(np.int32), rowmap


@pytest.mark.parametrize(
    "k,lengths,text",
    [
        (0, [3, 7, 12, 20], "planted"),  # k = 0: masked heads under 8 bytes
        (1, [16, 32], "planted"),  # 8-byte pieces
        (3, [32, 50], "random"),
        (3, [32, 50], "planted"),
        (5, [84, 50, 40], "planted"),  # 14-byte exact pieces, banded tier, a DP slot
        (8, [120, 70], "planted"),  # banded pieces of 24 and 14 bytes (7-byte heads)
        (16, [160, 170], "planted"),  # shift spans of 32
        (1, [32, 16], "all-A"),  # every position hits
        (8, [120], "all-A"),  # the band at every position
        (1, [40, 90], "full-byte-range"),
        (5, [84, 60], "full-byte-range"),
    ],
)
def test_kernel_design_model_matches_ref_and_apm(k, lengths, text):
    n_rows = 8  # apm's fold
    alphabet = bytes(range(256)) if text == "full-byte-range" else b"ACGT"
    rows, raw, plens, m_max, halo = _setup(lengths, k, n_rows, seed=200 + k, alphabet=alphabet)
    if text == "random":  # no planted copies: the text the card sees most
        rows = np.random.default_rng(7).choice(np.frombuffer(b"ACGT", np.uint8), rows.shape)
    elif text == "all-A":
        rows[:] = ord("A")
        raw[:] = np.where(raw > 0, ord("A"), 0).astype(np.uint8)
    start = WF
    bound = start + (n_rows - 2) * WF + 77  # a mid-row bound
    want = _check(rows, raw, bound, start, k, m_max, halo, plens)
    got = _model(rows, raw, bound, start, k, plens)
    assert got[0].tolist() == want[0].tolist()
    assert np.array_equal(got[1], want[1])
    if text == "all-A":
        assert (got[0][: len(lengths)] == bound - start).all()  # every owned window


@pytest.mark.parametrize("k", [0, 1, 3, 5, 8, 16])
def test_piece_words_hold_the_piece_bytes(k):
    # piece_layout names the bytes of each piece's head and tail words; the
    # words packed from them (the kernel's, and the model's above) hold them
    lengths = {0: [3, 8, 20], 1: [16, 50], 3: [32, 50], 5: [84, 50, 40], 8: [120, 70], 16: [160, 33]}[k]
    rows, raw, plens, m_max, _ = _setup(lengths, k, 2, seed=300 + k, alphabet=bytes(range(256)))
    table, pstart = filter_kernel.piece_layout(plens, k)
    assert table.shape[1] == filter_kernel.PIECE_COLS and not table.flags.writeable
    pieces, pstart_plan, _ = filter_kernel.piece_plan(plens, k)
    assert pstart.tolist() == pstart_plan.tolist() and len(table) == len(pieces)
    tiers = set()
    le = lambda b: int.from_bytes(bytes(b), "little")
    for p in range(len(plens)):
        for q in range(pstart[p], pstart[p + 1]):
            o, li, kp, s_lo, s_hi = pieces[q].tolist()
            off, span, li2, kp2, o2, tail_off, n_head, n_tail = table[q].tolist()
            assert (off, span, li2, kp2, o2) == (o + s_lo, s_hi - s_lo, li, kp, o)
            tiers.add(kp)
            assert n_head == (min(li, 8) if kp == 0 else min(8, li // 2))
            words = np.concatenate(_words(raw[p], table[q])).view("<u8").tolist()
            assert words[:2] == [le(raw[p, o : o + n_head]), (1 << 8 * n_head) - 1]
            if kp == 0:
                assert (n_tail, tail_off) == (0, 0) and words[2:] == [0, 0]
            else:  # the last ceil(li / 2) bytes, 8 at most, one byte before
                assert n_tail == min(8, (li + 1) // 2) and tail_off == li - n_tail - 1
                assert words[2:] == [le(raw[p, o + li - n_tail : o + li]), (1 << 8 * n_tail) - 1]
    assert tiers == {kp for m in plens if m for kp in [filter_kernel.tier_of(m, k)[1]]}


@pytest.mark.parametrize("li", [14, 15, 24])
def test_half_split_passes_every_single_edit(li):
    # a banded piece hit with one edit leaves its head or its tail intact at
    # drift -1, 0 or +1: the kernel's word test before the band drops no hit
    rng = np.random.default_rng(li)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    m = li * 5  # k = 8: five banded pieces of li bytes, the first at 0
    pat = acgt[rng.integers(0, 4, m)]
    raw = pat[None].copy()
    plens = (m,)
    assert filter_kernel.tier_of(m, 8) == (5, 1)
    table, _ = filter_kernel.piece_layout(plens, 8)
    piece = table[0]
    assert int(piece[2]) == li and int(piece[0]) == 0
    pc = filter_kernel.pchar_table(torch.from_numpy(raw), 1).numpy()[0]
    body = pat[:li]
    other = lambda c: acgt[(np.searchsorted(acgt, c) + 1) % 4]
    variants = [body.copy()]
    for e in range(li):
        sub = body.copy()
        sub[e] = other(sub[e])
        variants += [sub, np.delete(body, e)]
    for e in range(li + 1):
        variants += [np.insert(body, e, c) for c in acgt]
    n = 0
    for v in variants:
        for tail in (b"", b"A", b"TT"):
            text = np.concatenate([v, np.frombuffer(tail, np.uint8), acgt[rng.integers(0, 4, 40)]])
            assert _band(text, 0, pc, li)  # the variant is within one edit
            assert _half_split(text[None], 0, 1, piece, pat)[0, 0]
            n += 1
    assert n == 3 * (1 + 2 * li + 4 * (li + 1))


def test_launch_groups_and_stage_threads(monkeypatch):
    # the groups of patterns one launch of kernel D takes; its entry sizes
    # each block's threads to fit the group's tables and the staged text
    # (tests/test_torch_cuda.py: a halo that halves them)
    pstart = np.array([0, 5, 5, 14, 30, 30, 47], np.int32)
    monkeypatch.setattr(filter_kernel, "_PAT_GROUP", 2)
    monkeypatch.setattr(filter_kernel, "_PIECE_GROUP", 20)
    groups = filter_kernel.launch_groups(pstart)
    assert groups == ((0, 2), (2, 3), (3, 5), (5, 6))  # every piece once; empty groups dropped
    for p0, p1 in groups:
        assert p1 - p0 <= 2 and pstart[p1] - pstart[p0] <= 20


def test_item_rows_give_every_thread_windows_at_the_capture_shape():
    # 64 probes of 120 bytes at k = 12: 448 banded pieces, rows of 128
    # windows and a 256-byte halo. An item of 64 rows gives each of 256
    # threads a tile of 32 windows, and two such blocks fit an SM of an H100
    # (228 KB, 1 KB of it reserved a block)
    table, _ = filter_kernel.piece_layout((120,) * 64, 12)
    assert len(table) == 448
    items = filter_kernel.item_rows(128, 256, 448, 64)
    assert items == filter_kernel.Items(rows=64, threads=256, slot=384)
    assert items.threads * 32 == items.rows * 128
    smem = filter_kernel.block_smem(items, 448, 64)
    assert smem <= filter_kernel.SMEM_OPTIN and 2 * (smem + 1024) <= 228 * 1024
    (groups, launch), = filter_kernel.launch_items((120,) * 64, 12, 128, 256)
    assert groups == (0, 64) and launch == items


@pytest.mark.parametrize("wf", [4096, 8192, 16384])
def test_item_rows_keep_one_row_where_it_fills_half_a_block(wf):
    items = filter_kernel.item_rows(wf, 128, 24, 6)
    assert items.rows == 1
    assert items.threads == min(256, wf // 32)  # a segment of whole warps
    assert items.slot == items.threads * 32 + 128


@pytest.mark.parametrize("wf", [100, 1000, 4100])
def test_item_rows_keep_one_row_off_the_tile(wf):
    # a row that is not whole tiles: one warp (or more) a segment of one row
    items = filter_kernel.item_rows(wf, 256, 7, 1)
    assert items.rows == 1 and items.threads == min(256, -(-wf // 1024) * 32)


def test_item_rows_halve_to_fit_the_shared_memory():
    # a 2 KB halo at wf = 128: 64 rows take 470 KB, 16 rows fit
    items = filter_kernel.item_rows(128, 2048, 448, 64)
    assert items.rows == 16 and items.threads == 64
    assert filter_kernel.block_smem(items, 448, 64) <= filter_kernel.SMEM_OPTIN
    assert filter_kernel.block_smem(items._replace(rows=32, threads=128), 448, 64) > (
        filter_kernel.SMEM_OPTIN)
    # and a smaller device takes fewer rows
    assert filter_kernel.item_rows(128, 256, 448, 64, smem_max=64 << 10).rows == 16


@pytest.mark.parametrize("wf", [128, 256, 384, 512, 640, 1024, 2048])
@pytest.mark.parametrize("halo", [128, 256, 384])
def test_item_slots_hold_the_row_and_keep_warps_off_shared_banks(wf, halo):
    # tile t of slot i starts at logical byte i * slot + 32 t, physical
    # word 9 (i * slot / 32 + t) (a 4-byte gap every 32 bytes); the lanes
    # of a warp read the same word offset at once, so they need 32
    # different banks
    items = filter_kernel.item_rows(wf, halo, 16, 8)
    tiles = items.threads // items.rows
    assert items.rows > 1 and tiles * 32 == wf
    assert items.slot % 32 == 0 and items.slot >= wf + halo
    assert items.slot < wf + halo + 32 * 32
    for w0 in range(0, items.threads, 32):
        lanes = range(w0, min(w0 + 32, items.threads))
        banks = {9 * (t // tiles * items.slot // 32 + t % tiles) % 32 for t in lanes}
        assert len(banks) == len(lanes)


def _item_walk(rows, items, wf, bound, start, reach):
    """NumPy model of kernel D's item walk: items of ``items.rows`` rows
    (or row segments) staged slot by slot, each thread's tile of 32
    windows and the warp groups that sum a row's counts. Returns the
    windows each (row, window) is owned by and, for each owning thread,
    whether the ``32 + reach`` staged bytes from its first window are its
    row's own."""
    n_rows, width = rows.shape
    tiles = items.threads // items.rows
    seg = tiles * 32
    segs = -(-wf // seg)
    n_items = -(-n_rows // items.rows) * segs
    owners = np.zeros((n_rows, wf), np.int32)
    reads_own = []
    for t in range(n_items):
        g = t // segs
        r0, seg0 = g * items.rows, (t - g * segs) * seg
        buf = np.zeros(items.rows * items.slot + 128, np.uint8)
        for i in range(min(items.rows, n_rows - r0)):
            part = rows[r0 + i, seg0 : seg0 + items.slot]
            buf[i * items.slot : i * items.slot + len(part)] = part
        counted = {}
        for th in range(items.threads):
            slot, tile = divmod(th, tiles)
            lane, warp0 = th % 32, th - th % 32
            g0, g1 = max(slot * tiles - warp0, 0), min((slot + 1) * tiles - warp0, 32)
            assert g0 <= lane < g1
            r, j0 = r0 + slot, seg0 + tile * 32
            lim = 0 if r >= n_rows else int(np.clip(bound - start - r * wf, 0, wf))
            nown = int(np.clip(lim - j0, 0, 32))
            if nown:
                owners[r, j0 : j0 + nown] += 1
                x0 = slot * items.slot + tile * 32
                want = rows[r, j0 : j0 + 32 + reach]
                reads_own.append(np.array_equal(buf[x0 : x0 + len(want)], want))
            counted.setdefault((warp0, r, g0), []).append(lane)
        for (warp0, r, g0), lanes in counted.items():  # one leader a group: its first lane
            assert min(lanes) == g0 and len(lanes) == len(set(lanes))
    return owners, reads_own


@pytest.mark.parametrize("wf,n_rows", [(128, 197), (256, 70), (384, 50), (4096, 5), (8320, 3)])
def test_item_walk_model_owns_each_window_once_from_its_own_row(wf, n_rows):
    # rows of unrelated bytes: a thread that read a neighbour's slot, or
    # staged the wrong row, would see other bytes
    k, lengths = 8, (120, 70)
    table, _ = filter_kernel.piece_layout(lengths, k)
    reach = int((table[:, 0] + table[:, 1] + table[:, 2] + table[:, 3]).max())
    halo = round_up(120 + 2 * k, 128)
    assert reach <= halo
    rows = np.random.default_rng(wf).integers(0, 256, (n_rows, wf + halo), dtype=np.uint8)
    items = filter_kernel.item_rows(wf, halo, len(table), len(lengths))
    start = 3 * wf
    for bound in (start + (n_rows // 2) * wf + 45, start + n_rows * wf - 1):
        owners, reads_own = _item_walk(rows, items, wf, bound, start, reach)
        owned = np.arange(wf)[None, :] < np.clip(bound - start - np.arange(n_rows) * wf, 0, wf)[:, None]
        assert np.array_equal(owners, owned.astype(np.int32))
        assert reads_own and all(reads_own)
