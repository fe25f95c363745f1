"""The port's Scanner.count_batch and its kernels' plain versions, held
against apm (Pallas in interpret mode) and the oracle.

Kernel level: the plain batch mode of the banded DP (TPU kernel #4, band
and Myers) against ``apm.ops.pallas_kernel.scan_folded_pallas_batch``, and
the plain batch mode of the correlation (TPU kernel #8) against
``apm.ops.corr_fused.scan_corr_batch_fused``, on the same staged rows, meta
and limits. Entry level: ``count_batch`` three ways (port, apm, oracle) at
several k and engines, with several groups, short and empty corpora and
duplicate patterns, the k = 0 conv route (``apm``'s ``scan_corr_batch``)
under ``corr_impl="conv"`` and past the fused kernel, and the refusals.
Every output is an integer count: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

import apm
from apm import ApmConfig as JaxConfig
from apm.utils.oracle import count_matches

import apm_torch
from apm_torch import ApmConfig
from apm_torch.ops import corr_fused, dp_kernel
from apm_torch.ops.common import fold_corpus, round_up
from apm_torch.utils.corpus import plant


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PALLAS = dict(backend="pallas", interpret=True, block_windows=1024)


def _corpus(n, seed, alphabet=b"ACGT\n"):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), size=n)]


def _patterns(lengths, seed):
    return [bytes(_corpus(m, seed + i, b"ACGT")) for i, m in enumerate(lengths)]


def _batch_rows(corpora, w, wf, halo, n_slots, bound_of):
    """Rows, meta and limits of a batch as count_batch stages them: each
    corpus's blocks folded from that corpus alone, padding slots last."""
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
    assert 0 < slot < n_slots  # real blocks and at least one padding block
    return rows, meta, limits


def _table(pats, k):
    from apm_torch.utils.io import PatternSet

    ps = PatternSet.from_patterns(pats)
    packed, _ = ps.packed(k)
    pat = np.zeros((8, packed.shape[1]), np.uint8)
    pat[: len(pats)] = packed
    raw = np.zeros((8, ps.max_len), np.uint8)
    raw[: len(pats)] = ps.table
    plens = tuple(len(p) for p in pats) + (0,) * (8 - len(pats))
    return pat, raw, plens, ps.max_len


@pytest.mark.parametrize("k,dp_impl", [(0, "band"), (1, "band"), (3, "myers"), (3, "band"), (5, "auto")])
def test_batch_dp_plain_matches_pallas(k, dp_impl):
    from apm.ops.pallas_kernel import scan_folded_pallas_batch

    pats = _patterns([20, 33, 12], 700 + k)
    corpora = [_corpus(n, 710 + i) for i, n in enumerate([700, 2300, 90, 1500])]
    for c in corpora[:2]:
        plant(c, np.frombuffer(pats[0], np.uint8), [30, 600], k=min(k, 2), seed=k)
    plant(corpora[3], np.frombuffer(pats[1], np.uint8), [1300], k=min(k, 2), seed=k)
    pat, _, plens, m_max = _table(pats, k)
    wf, halo = 128, round_up(m_max + 2 * k, 128)
    rows, meta, _ = _batch_rows(corpora, 8 * wf, wf, halo, 8,
                                lambda n: max(0, min(n - m_max + 1, n - k)))
    alph = tuple(sorted(set(b"".join(pats))))
    kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens, alphabet=alph, dp_impl=dp_impl)
    got = dp_kernel.scan_folded_dp_batch(
        torch.from_numpy(rows), torch.from_numpy(pat), torch.from_numpy(meta), **kw
    )
    want = np.asarray(scan_folded_pallas_batch(rows, pat, meta, interpret=True, **kw))
    assert got.shape == (8, 8) and got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    assert int(got.sum()) > 0
    assert got[-1].sum() == 0  # the padding block counts nothing


@pytest.mark.parametrize("lengths", [[50, 32], [20] * 40, [80, 70]])
def test_batch_corr_plain_matches_pallas(lengths):
    from apm.ops.corr_engine import n_bitplanes
    from apm.ops.corr_fused import batch_owner, pick_g, pick_s, scan_corr_batch_fused
    from apm_torch.ops.corr_engine import build_alphabet

    pats = _patterns(lengths, 720)
    corpora = [_corpus(n, 730 + i, b"ACGT") for i, n in enumerate([3000, 700, 1500])]
    for i, p in enumerate(pats[:6]):
        c = corpora[i % 3]
        at = (97 * i) % (len(c) - len(p))
        c[at : at + len(p)] = np.frombuffer(p, np.uint8)
    m_max = max(lengths)
    raw = np.zeros((len(pats), m_max), np.uint8)
    for i, p in enumerate(pats):
        raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)
    km, thr = corr_fused.build_fused_tables(raw, lengths, alph)
    s_ph = corr_fused.pick_s(m_max)
    wf, halo = 256, 128
    rows, _, limits = _batch_rows(corpora, 8 * wf, wf, halo, 6, lambda n: n - m_max + 1)
    tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, s_ph, "cpu")
    p_out = round_up(len(pats), 8)
    got = corr_fused.scan_corr_batch_fused(
        torch.from_numpy(rows), tabs, torch.from_numpy(limits), wf=wf, halo=halo,
        p_out=p_out,
    )
    p = km.shape[1] // s_ph
    l128 = (wf + halo) // 128
    want = scan_corr_batch_fused(
        rows, km if km.dtype == np.int8 else km.astype(np.float32), thr,
        batch_owner(p, s_ph), alph, limits, wf=wf, l128=l128, fold=8,
        g=pick_g(rows.shape[0], l128, p), p=p, c_alpha=len(alph),
        b_planes=n_bitplanes(len(alph)), s_ph=pick_s(m_max), interpret=True,
        p_out=p_out,
    )
    assert got.numpy().tolist() == np.asarray(want).tolist()
    assert int(got.sum()) >= min(6, len(pats))


def _three_way_batch(pats, k, corpora, **cfg):
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=1024, **cfg))
    jsc = apm.Scanner(pats, k, JaxConfig(**PALLAS, **cfg))
    got = tsc.count_batch(corpora)
    assert got.shape == (len(corpora), len(pats)) and got.dtype == np.int64
    assert got.tolist() == jsc.count_batch(corpora).tolist()
    for b, c in enumerate(corpora):
        assert got[b].tolist() == count_matches(c, pats, k), b
    return tsc, got


def _corpora(seed, k, pat):
    cs = [
        _corpus(700, seed),  # shorter than one block
        _corpus(9000, seed + 1),  # several blocks
        _corpus(15, seed + 2),  # tail only
        np.zeros((0,), np.uint8),
        _corpus(4096, seed + 3),
        _corpus(2, seed + 4),  # no longer than k (k >= 2): zeros
    ]
    plant(cs[1], np.frombuffer(pat, np.uint8), [100, 1000, 5000, 8900], k=min(k, 2), seed=seed)
    plant(cs[4], np.frombuffer(pat, np.uint8), [4040], k=min(k, 2), seed=seed)
    return cs


@pytest.mark.parametrize(
    "k,engine",
    [(0, "auto"), (0, "dp"), (0, "corr"), (1, "auto"), (1, "dp"), (2, "auto"),
     (3, "auto"), (3, "dp"), (5, "auto")],
)
def test_count_batch_three_way(k, engine, monkeypatch):
    # k = 0: nine 50-mers, which the correlation takes under "auto"; k >= 1:
    # 20 and 33 bytes, the banded DP (Myers mode from k = 3). batch_blocks=8:
    # 15 blocks in two groups.
    if k == 0:
        pats = _patterns([50] * 9, 740)
    else:
        pats = _patterns([20, 33], 740 + k)
    pats.append(pats[0])  # a duplicate
    calls = []
    for mod, name in ((corr_fused, "scan_corr_batch_fused"), (dp_kernel, "scan_folded_dp_batch")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw: calls.append(_n) or _f(*a, **kw))
    tsc, got = _three_way_batch(pats, k, _corpora(750 + k, k, pats[0]), engine=engine, batch_blocks=8)
    want_kernel = "scan_corr_batch_fused" if k == 0 and engine != "dp" else "scan_folded_dp_batch"
    assert calls == [want_kernel] * 2
    assert got[1, 0] >= 4
    assert got[:, -1].tolist() == got[:, 0].tolist()


def test_count_batch_group_sizes():
    # the groups follow batch_blocks and chunk_bytes, powers of two, >= 8
    pats = _patterns([20], 760)
    corpora = [_corpus(3000, 761 + i) for i in range(6)]
    for cfg in (dict(chunk_bytes=1 << 16), dict(batch_blocks=20), dict(batch_blocks=1)):
        tsc = apm_torch.Scanner(pats, 1, ApmConfig(device="cpu", block_windows=1024, **cfg))
        assert tsc.count_batch(corpora).tolist() == [count_matches(c, pats, 1) for c in corpora]


def test_count_batch_empty_and_short():
    pats = _patterns([20, 33], 770)
    tsc = apm_torch.Scanner(pats, 3, ApmConfig(device="cpu"))
    out = tsc.count_batch([])
    assert out.shape == (0, 2) and out.dtype == np.int64
    short = [b"", b"A", b"ACG", _corpus(30, 771)]
    assert tsc.count_batch(short).tolist() == [count_matches(c, pats, 3) for c in short]


def test_count_batch_torch_backend_runs_the_batched_layout(monkeypatch):
    # backend="torch" runs the batch layout on the plain versions, never a
    # loop over count()
    pats = _patterns([20, 33], 780)
    tsc = apm_torch.Scanner(pats, 1, ApmConfig(device="cpu", backend="torch"))
    monkeypatch.setattr(tsc, "count", lambda *a: pytest.fail("count_batch looped over count"))
    corpora = [_corpus(5000, 781), _corpus(100, 782)]
    assert tsc.count_batch(corpora).tolist() == [count_matches(c, pats, 1) for c in corpora]


def _conv_calls(monkeypatch):
    from apm_torch.ops import corr_engine

    calls = []
    fn = corr_engine.scan_corr_batch
    monkeypatch.setattr(corr_engine, "scan_corr_batch",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    return calls


def test_count_batch_conv_route(monkeypatch):
    # k = 0 with 97 < m_max <= 512 under "auto": apm's XLA conv
    # (scan_corr_batch), in the port conv1d
    calls = _conv_calls(monkeypatch)
    pats = _patterns([100, 20], 790)
    corpora = _corpora(791, 0, pats[0])
    _, got = _three_way_batch(pats, 0, corpora)
    assert calls and got[1, 0] >= 4


@pytest.mark.parametrize(
    "lengths,cfg",
    [
        ([50] * 9, dict(corr_impl="conv")),  # the fused gate holds; conv pinned
        ([100], dict(engine="corr")),  # past the fused kernel
    ],
)
def test_count_batch_conv_options(lengths, cfg, monkeypatch):
    calls = _conv_calls(monkeypatch)
    pats = _patterns(lengths, 801)
    corpora = _corpora(802, 0, pats[0]) + [_corpus(2000, 800)]
    _, got = _three_way_batch(pats, 0, corpora, batch_blocks=8, **cfg)
    assert len(calls) == 2 and got[1, 0] >= 4


def test_count_batch_refusals():
    wide = bytes(range(40))  # alphabet 40 > ALPHABET_MAX
    corpora = [_corpus(2000, 800)]
    for pkg, cfg in ((apm_torch, ApmConfig(device="cpu", engine="corr")),
                     (apm, JaxConfig(engine="corr", **PALLAS))):
        with pytest.raises(ValueError, match="corr"):
            pkg.Scanner([wide], 0, cfg).count_batch(corpora)
    for pkg, cfg in ((apm_torch, ApmConfig(device="cpu", corr_impl="fused")),
                     (apm, JaxConfig(corr_impl="fused", **PALLAS))):
        with pytest.raises(ValueError, match="fused"):
            pkg.Scanner(_patterns([100], 803), 0, cfg).count_batch(corpora)


def test_batch_wrappers_check_their_inputs():
    rows = torch.zeros((12, 256), dtype=torch.uint8)
    pat = torch.zeros((8, 22), dtype=torch.uint8)
    kw = dict(k=1, m_max=20, wf=128, halo=128, plens=(20,) + (0,) * 7)
    with pytest.raises(ValueError, match="multiple of 8"):
        dp_kernel.scan_folded_dp_batch(rows, pat, torch.zeros((1, 2), dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="meta"):
        dp_kernel.scan_folded_dp_batch(rows[:8], pat, torch.zeros((2, 2), dtype=torch.int32), **kw)


@pytest.mark.parametrize("k,route", [(0, "corr batch"), (1, "dp batch"), (0, "conv batch")])
def test_count_batch_spans_sum_within_the_call(k, route):
    # with the meter's trace on, one call leaves its own split: the staging
    # fold, the copy, the route's launches, the fetch and the EOF tails
    pats = _patterns([50] * 3 if k == 0 else [20, 33], 810 + k)
    cfg = dict(corr_impl="conv") if route == "conv batch" else {}
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=1024, batch_blocks=8, **cfg))
    corpora = _corpora(811 + k, k, pats[0])
    want = tsc.count_batch(corpora)
    assert tsc.meter.last_spans == {}  # off by default
    tsc.meter.trace = True
    got = tsc.count_batch(corpora)
    spans = tsc.meter.last_spans
    assert got.tolist() == want.tolist()
    assert set(spans) == {"call", "fold", "copy", route, "fetch", "wait", "EOF tail"}
    assert all(v >= 0 for v in spans.values())
    # on the CPU every span is on the host clock, and the call's own spans
    # (``wait`` lies inside ``fetch``) run one after another within it
    inside = [r for r in tsc.meter.last_records if r.parent == "call"]
    assert {r.name for r in inside} == set(spans) - {"call", "wait"}
    assert sum(r.end - r.start for r in inside) <= spans["call"]
    assert tsc.last_duration * 1e3 <= spans["call"]


@pytest.mark.parametrize("bad", ["fold", "limits dtype", "limits shape", "rows width", "halo", "m_max"])
def test_corr_batch_wrapper_checks_its_inputs(bad):
    from apm_torch.ops.corr_engine import build_alphabet

    lengths = [120] if bad == "m_max" else [50, 32]
    pats = _patterns(lengths, 820)
    raw = np.zeros((len(pats), max(lengths)), np.uint8)
    for i, p in enumerate(pats):
        raw[i, : len(p)] = np.frombuffer(p, np.uint8)
    alph = build_alphabet(pats)
    if bad == "m_max":  # past the fused kernel's 97 bytes: no tables at all
        with pytest.raises(ValueError, match="97"):
            corr_fused.build_fused_tables(raw, lengths, alph)
        return
    km, thr = corr_fused.build_fused_tables(raw, lengths, alph)
    tabs = corr_fused.FusedTables.from_numpy(km, thr, alph, corr_fused.pick_s(max(lengths)), "cpu")
    wf, halo = 256, 128
    rows = torch.zeros((16, wf + halo), dtype=torch.uint8)
    limits = torch.full((16,), wf, dtype=torch.int32)
    kw = dict(wf=wf, halo=halo)
    args = {
        "fold": (rows[:12], limits[:12], kw, "multiple of fold"),
        "limits dtype": (rows, limits.to(torch.int64), kw, "limits"),
        "limits shape": (rows, limits[:8], kw, "limits"),
        "rows width": (rows[:, :-1], limits, kw, "rows shape"),
        "halo": (torch.zeros((16, wf + 64), dtype=torch.uint8), limits, dict(wf=wf, halo=64), "halo"),
    }[bad]
    with pytest.raises(ValueError, match=args[3]):
        corr_fused.scan_corr_batch_fused(args[0], tabs, args[1], **args[2])


def test_corr_batch_staging_is_16_byte_aligned():
    # kernel #8 reads rows with 16-byte loads and raises on any other rows
    # (no copy in their stead); count_batch's staging always qualifies, a
    # shifted view never does, and on the CPU both take the plain version
    pats = _patterns([50, 32], 830)
    tsc = apm_torch.Scanner(pats, 0, ApmConfig(device="cpu", block_windows=1024))
    wf = 1024 // 8
    host = tsc._host_rows(64, wf + 128)
    corr_fused.check_aligned_rows(host)
    corr_fused.check_aligned_rows(host[8:])
    flat = host.reshape(-1)[1 : 1 + 56 * host.shape[1]].view(56, host.shape[1])
    with pytest.raises(ValueError, match="16-byte"):
        corr_fused.check_aligned_rows(flat)
