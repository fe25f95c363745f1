"""The port's Scanner at k >= 1 on apm's own routes, three ways.

``apm_torch.Scanner(..., ApmConfig(device="cpu"))`` (plain versions of
kernels A, C and D, the piece conv, device-side phase 2 and
``finalize_filtration``), ``apm.Scanner`` (its Pallas kernels in interpret
mode) and the oracle ``count_matches`` must give the same counts — integers,
tolerance 0 — on every branch of the filtration decision tree: on-device
verify, density rescan, overflow through ``count_hot_batch``, the
host-staged ``verify_rows_host`` and a clipped hot row; and for the k = 0
short-set filter route. Also: the port names the same kernel for each
pattern as apm's plan does.
"""

import numpy as np
import pytest
import torch

import apm
from apm import ApmConfig as JaxConfig
from apm.utils.oracle import count_matches

import apm_torch
from apm_torch import ApmConfig
from apm_torch.utils.corpus import plant


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


def _patterns(lengths, seed):
    return [bytes(_corpus(m, seed + i, b"ACGT")) for i, m in enumerate(lengths)]


def _planted(n, pats, k, seed, every):
    c = _corpus(n, seed)
    for i, p in enumerate(pats):
        plant(c, np.frombuffer(p, np.uint8), range(400 + 97 * i, n - 300, every),
              k=min(k, 3), seed=seed + i)
    return c


def _three_way(c, pats, k, **cfg):
    want = count_matches(c, pats, k)
    jsc = apm.Scanner(pats, k, JaxConfig(backend="pallas", interpret=True,
                                         block_windows=1024, **cfg))
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", block_windows=1024, **cfg))
    got = tsc.count(c).tolist()
    assert got == want, ("port", got, want)
    assert jsc.count(c).tolist() == want, "apm"
    return tsc, want


@pytest.mark.parametrize(
    "k,lengths,engine,dp_impl",
    [
        (1, [32, 50], "auto", "auto"),  # conv phase 1, phase 2 on kernel A
        (2, [32, 50], "auto", "auto"),
        (3, [32, 50], "auto", "auto"),  # kernel D, phase 2 on kernel C
        (4, [50, 50, 50], "auto", "auto"),  # conv phase 1, kernel C
        (8, [120, 120], "auto", "auto"),  # kernel D banded tier, kernel C
        (12, [50, 50], "auto", "auto"),  # DP route on kernel C
        (1, [32, 50, 9], "filter", "auto"),  # kernel D; m = 9 on the DP route
        (3, [32, 50], "filter", "myers"),
        (4, [50, 50], "filter", "band"),
        (2, [32, 50], "dp", "myers"),  # the bit-parallel band at k = 2
    ],
)
def test_count_three_way(k, lengths, engine, dp_impl):
    pats = _patterns(lengths, 20 + k)
    c = _planted(40_000, pats, k, seed=k, every=6_000)
    tsc, want = _three_way(c, pats, k, engine=engine, dp_impl=dp_impl)
    assert sum(want[:2]) > 0
    routes = {r for r in (tsc.last_filtration or {}).values() if isinstance(r, str)}
    assert routes <= {"device-verify"}


@pytest.mark.parametrize("engine", ["auto", "filter"])
def test_count_k0_short_set_filter_route(engine):
    # k = 0, m_max < 48, a light set: apm's plan sends it to the shift-OR
    # filter, whose candidates are the exact counts
    from apm_torch.models.pipeline import make_plan

    pats = _patterns([12, 20], 40)
    c = _planted(30_000, pats, 0, seed=41, every=3_000)
    tsc, want = _three_way(c, pats, 0, engine=engine)
    plan = make_plan(tsc, len(c))
    assert plan.plens_filter[:2] == (12, 20) and not plan.use_corr
    assert min(want) >= 9


def test_count_density_rescan():
    # a candidate in most rows: past the density threshold, the filtration
    # patterns are rescanned with the banded DP
    pats = _patterns([32, 50], 50)
    c = _planted(40_000, pats, 1, seed=51, every=150)
    tsc, _ = _three_way(c, pats, 1)
    assert tsc.last_filtration["route"] == "rescan"


def test_count_overflow_through_count_hot_batch(monkeypatch):
    # more full hot rows than the bucket, fewer than the density threshold:
    # the overflowed chunk is re-verified on the device
    from apm.ops import fused as jfused
    from apm_torch.ops import fused as tfused

    monkeypatch.setattr(jfused, "pick_max_hot", lambda *a: 8)
    monkeypatch.setattr(tfused, "pick_max_hot", lambda *a: 8)
    pats = _patterns([32, 50], 60)
    c = _planted(40_000, pats, 3, seed=61, every=2_500)
    tsc, _ = _three_way(c, pats, 3)
    info = tsc.last_filtration
    assert info["route"] == "count_hot_batch" and info["n_hot"] > 8


def test_count_overflow_past_the_cap_verifies_on_the_host(monkeypatch):
    from apm.ops import fused as jfused
    from apm_torch.ops import fused as tfused

    for mod in (jfused, tfused):
        monkeypatch.setattr(mod, "pick_max_hot", lambda *a: 8)
        monkeypatch.setattr(mod, "OVERFLOW_BATCH", 8)
        monkeypatch.setattr(mod, "OVERFLOW_CAP", 8)
    pats = _patterns([32, 50], 70)
    c = _planted(40_000, pats, 1, seed=71, every=2_500)
    tsc, _ = _three_way(c, pats, 1)
    info = tsc.last_filtration
    assert info["route"] == "verify_rows_host" and info["n_hot"] > 8


def test_count_clipped_hot_row():
    # a match whose window starts in the last, partial staging row: that
    # row is verified on the host
    pats = _patterns([32, 50], 80)
    wf = 1024 // 8
    n = wf * 300 + 60 + 49  # device bound n - 49 ends 60 windows into a row
    c = _corpus(n, 81)
    dev_bound = n - 50 + 1
    assert dev_bound % wf == 60
    c[dev_bound - 20 : dev_bound + 30] = np.frombuffer(pats[1], np.uint8)
    c[dev_bound - 10] ^= 1  # one substitution
    tsc, want = _three_way(c, pats, 2)
    assert want[1] >= 1 and tsc.last_filtration["route"] == "device-verify"


def _apm_kernels(jsc, n):
    """apm's kernel for each pattern slot, from its plan and dispatch."""
    from apm.models.pipeline import make_plan
    from apm.ops.pallas_kernel import resolve_dp_mode

    plan = make_plan(jsc, n, "pallas")
    mode = lambda plens: "dp_" + resolve_dp_mode(
        jsc.k, jsc._dp_alphabet(), "int32", jsc.config.dp_impl, len(plens), jsc.m_max
    )[1]
    out = []
    for i in range(len(plan.fmask)):
        if plan.use_corr and plan.plens_corr[i]:
            out.append("corr_fused" if jsc._use_fused_corr(plan.wf, plan.halo) else "corr_conv")
        elif plan.plens_filter[i]:
            phase1 = "piece_conv" if plan.fp1_conv else "filter_pieces"
            out.append(phase1 if jsc.k == 0 else f"{phase1}+{mode(plan.plens_filter)}")
        elif plan.plens_dp[i]:
            out.append(mode(plan.plens_dp))
        else:
            out.append("-")
    return out


def _port_kernels(tsc, n):
    from apm_torch.models.pipeline import make_plan

    plan = make_plan(tsc, n)
    corr, fp1 = plan.routes.corr, plan.routes.fp1
    mode = lambda plens: "dp_" + plan.routes.dp_mode
    out = []
    for i in range(len(plan.fmask)):
        if corr and plan.plens_corr[i]:
            out.append(f"corr_{corr}")
        elif plan.plens_filter[i]:
            phase1 = {"conv": "piece_conv", "fused": "pieces_fused", None: "filter_pieces"}[fp1]
            out.append(phase1 if tsc.k == 0 else f"{phase1}+{mode(plan.plens_filter)}")
        elif plan.plens_dp[i]:
            out.append(mode(plan.plens_dp))
        else:
            out.append("-")
    return out


def test_routes_name_apms_kernels():
    seen = set()
    for lengths, alphabet in (([32, 50], b"ACGT"), ([12, 20], b"ACGT"), ([50] * 6, b"ACGT"),
                              ([120, 120, 9], b"ACGT"), ([40, 60], b"ACDEFGHIKL")):
        pats = [bytes(_corpus(m, 90 + i, alphabet)) for i, m in enumerate(lengths)]
        for k in (0, 1, 2, 3, 4, 8, 12):
            for engine in ("auto", "filter", "dp"):
                for dp_impl in ("auto", "band", "myers"):
                    cfg = dict(engine=engine, dp_impl=dp_impl)
                    jsc = apm.Scanner(pats, k, JaxConfig(backend="pallas", interpret=True, **cfg))
                    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", **cfg))
                    want = _apm_kernels(jsc, 1 << 22)
                    seen.update(want)
                    assert _port_kernels(tsc, 1 << 22) == want, (lengths, k, cfg)
    assert {"corr_fused", "corr_conv", "dp_band", "dp_myers", "filter_pieces",
            "piece_conv+dp_band", "piece_conv+dp_myers",
            "filter_pieces+dp_band", "filter_pieces+dp_myers"} <= seen


def _split_set(k, lengths, dense_every, sparse_every, seed, n=40_000):
    """Pattern 0 planted every ``dense_every`` bytes, the others every
    ``sparse_every``: one pattern's candidates in most rows, the others'
    in a few."""
    pats = _patterns(lengths, seed)
    c = _corpus(n, seed + 1)
    for i, p in enumerate(pats):
        every = dense_every if i == 0 else sparse_every
        plant(c, np.frombuffer(p, np.uint8), range(400 + 97 * i, n - 300, every),
              k=min(k, 3), seed=seed + 2 + i)
    return c, pats


def _clipped_split_set():
    """A dense 32-mer, a 50-mer whose one copy starts in the last, partial
    staging row (as in :func:`test_count_clipped_hot_row`) and a sparse
    50-mer."""
    pats = _patterns([32, 50, 50], 110)
    wf = 1024 // 8
    n = wf * 300 + 60 + 49  # device bound n - 49 ends 60 windows into a row
    c = _corpus(n, 111)
    plant(c, np.frombuffer(pats[0], np.uint8), range(400, n - 300, 150), k=2, seed=112)
    plant(c, np.frombuffer(pats[2], np.uint8), range(600, n - 300, 6000), k=2, seed=113)
    dev_bound = n - 50 + 1
    assert dev_bound % wf == 60
    c[dev_bound - 20 : dev_bound + 30] = np.frombuffer(pats[1], np.uint8)
    c[dev_bound - 10] ^= 1  # one substitution
    return c, pats


@pytest.mark.parametrize(
    "case,k,lengths,dense_every,sparse_every,cfg,fp1,route,sparse",
    [
        ("filter", 3, [32, 50, 50, 50], 150, 6_000, dict(engine="filter"), None,
         "split-rescan", [1, 2, 3]),
        ("conv", 1, [32, 50, 50], 150, 6_000, {}, "conv", "split-rescan", [1, 2]),
        ("fused", 1, [32, 50, 50], 150, 6_000, dict(corr_impl="fused"), "fused",
         "split-rescan", [1, 2]),
        ("chunks", 3, [32, 50, 50, 50], 150, 6_000,
         dict(engine="filter", chunk_bytes=16 << 10), None, "split-rescan", [1, 2, 3]),
        ("all dense", 3, [32, 50], 150, 150, {}, None, "rescan", None),
        # each pattern alone passes the threshold (64 rows of 312)
        ("each past the threshold", 1, [50, 50], 450, 450, {}, "conv", "rescan", None),
        # the sparse patterns' rows pass the device compaction's cap
        ("past the cap", 3, [32, 50, 50], 150, 3_000, {}, None, "rescan", None),
        ("clipped", 2, [32, 50, 50], None, None, {}, "conv", "split-rescan", [1, 2]),
    ],
)
def test_count_split_rescan(monkeypatch, case, k, lengths, dense_every, sparse_every,
                            cfg, fp1, route, sparse):
    """A dense set whose patterns are not all dense: the sparse ones are
    verified on their hot rows on the device (and their clipped rows on the
    host) and the rest rescanned, with each phase-1 engine and over several
    chunks; a set with no pattern sparse enough keeps the whole-set
    rescan. Counts three ways."""
    from apm_torch.models import pipeline
    from apm_torch.models.pipeline import make_plan
    from apm_torch.ops import fused as tfused

    host_rows = []  # the slots each clipped row is verified for on the host
    verify_clipped = pipeline._verify_clipped_row

    def spy(reader, plan, n, j0, fcnt, **kw):
        host_rows.append(np.flatnonzero(np.asarray(plan.fmask) & (fcnt > 0)).tolist())
        return verify_clipped(reader, plan, n, j0, fcnt, **kw)

    monkeypatch.setattr(pipeline, "_verify_clipped_row", spy)
    if case == "past the cap":
        monkeypatch.setattr(tfused, "OVERFLOW_BATCH", 8)
        monkeypatch.setattr(tfused, "OVERFLOW_CAP", 8)
    if case == "clipped":
        c, pats = _clipped_split_set()
    else:
        c, pats = _split_set(k, lengths, dense_every, sparse_every, seed=90 + 10 * k)
    tsc, want = _three_way(c, pats, k, **cfg)
    assert want[0] > 0 and (sparse is None or all(want[s] > 0 for s in sparse))
    info = tsc.last_filtration
    assert info["route"] == route and info.get("sparse") == sparse
    plan = make_plan(tsc, len(c))
    assert plan.routes.fp1 == fp1
    if case == "chunks":
        assert tsc._count_setup(plan).chunk_win < plan.dev_bound
    if route == "split-rescan":
        # only the sparse patterns with a candidate in the clipped row
        assert all(0 < len(r) and set(r) <= set(sparse) for r in host_rows), host_rows
    if case == "clipped":
        assert [1] in host_rows


def test_sparse_patterns_takes_the_longest_prefix_within_threshold_and_cap():
    """:func:`sparse_patterns` takes the filtration slots with the fewest hot
    rows, as many as fit the density threshold and, in every chunk, the
    cap; none or all of them is no split."""
    from apm_torch.models.pipeline import candidate_density_dense, sparse_patterns

    wf, dev_bound, cap = 128, 100_000, 60  # threshold: 64 rows
    fmask = (True, True, True, False, True)
    one = [np.array([30, 2, 20, 9, 100])]
    assert sparse_patterns(one, fmask, wf, dev_bound, cap).tolist() == [
        True, True, True, False, False]  # 2 + 20 + 30 <= 64, + 100 is not
    assert sparse_patterns(one, fmask, wf, dev_bound, 25).tolist() == [
        False, True, True, False, False]  # the cap stops at 2 + 20
    assert sparse_patterns([np.array([70, 80, 65, 0, 90])], fmask, wf, dev_bound, cap) is None
    assert sparse_patterns([np.array([1, 2, 3, 500, 4])], fmask, wf, dev_bound, cap) is None
    two = [np.array([10, 0, 30, 0, 60]), np.array([25, 5, 0, 0, 4])]
    # summed: 35, 5, 30, -, 64; 5 + 30 = 35 fits, + 35 = 70 does not
    assert np.flatnonzero(sparse_patterns(two, fmask, wf, dev_bound, cap)).tolist() == [1, 2]

    rng = np.random.default_rng(0)
    for _ in range(300):
        n_chunks, p = rng.integers(1, 4), rng.integers(1, 7)
        hot = [rng.integers(0, 60, p) for _ in range(n_chunks)]
        fm = rng.random(p) < 0.8
        got = sparse_patterns(hot, fm, wf, dev_bound, cap)
        per = np.array(hot)
        slots = np.flatnonzero(fm)
        if got is None:
            continue
        s = np.flatnonzero(got)
        assert 0 < len(s) < len(slots) and set(s) <= set(slots)
        assert not candidate_density_dense(per[:, s].sum(), wf, dev_bound)
        assert (per[:, s].sum(axis=1) <= cap).all()
        rest = np.setdiff1d(slots, s)
        # the fewest rows first, and no pattern of the rest would fit as well
        assert per[:, s].sum(axis=0).max() <= per[:, rest].sum(axis=0).min()
        nxt = rest[np.argmin(per[:, rest].sum(axis=0))]
        more = np.append(s, nxt)
        assert (candidate_density_dense(per[:, more].sum(), wf, dev_bound)
                or (per[:, more].sum(axis=1) > cap).any())
