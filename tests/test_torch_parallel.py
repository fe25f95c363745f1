"""The port's distribution strategies on the CPU, against the oracle and apm.

``tests/test_parallel.py``'s cases over ``apm_torch``: ``max_devices``
logical CPU devices (``Scanner.devices()``; several shards on one CPU, as
apm's tests put 8 virtual devices on it) run ``database_over_devices`` and
``patterns_over_devices`` through the plain versions of the kernels. Counts
are integers and must be equal (tolerance 0) to ``count_matches``, to the
single-device scan and, where stated, to ``apm``'s own strategies on its
8 virtual CPU devices (Pallas in interpret mode). Also: the packed layout
of the sharded filtration against apm's ``_collective_pack`` and
``_unpack_sharded``, ``_pattern_groups`` and the ``auto`` routing against
apm's, and every sharded branch of ``finalize_filtration`` by its route.
"""

import numpy as np
import pytest
import torch

import apm_torch
from apm_torch import ApmConfig
from apm_torch.ops import fused as tfused
from apm_torch.parallel import strategies
from apm_torch.utils.corpus import plant, random_corpus, random_pattern
from apm_torch.utils.oracle import count_matches

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_dna(n, seed, alphabet=b"ACGT\n"):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    return alpha[rng.integers(0, len(alpha), size=n)]


def mk_scanner(pats, k, strategy, n_dev=8, **kw):
    cfg = ApmConfig(device="cpu", strategy=strategy, block_windows=1024,
                    max_devices=n_dev, **kw)
    return apm_torch.Scanner(pats, k, cfg)


def jax_scanner(pats, k, strategy, n_dev=8, backend="pallas", **kw):
    import apm

    cfg = apm.ApmConfig(backend=backend, interpret=backend == "pallas", strategy=strategy,
                        block_windows=1024, max_devices=n_dev, **kw)
    return apm.Scanner(pats, k, cfg)


@pytest.mark.parametrize("strategy", ["database_over_devices", "patterns_over_devices"])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_strategy_vs_oracle(strategy, k):
    corpus = random_dna(12_000, seed=k)
    pats = [bytes(random_dna(m, seed=50 + m, alphabet=b"ACGT")) for m in [5, 18, 50, 7]]
    sc = mk_scanner(pats, k, strategy)
    got = sc.count(corpus)
    assert got.tolist() == count_matches(corpus, pats, k)
    assert sc.last_strategy == strategy


def test_strategies_agree_with_single():
    corpus = random_dna(6000, seed=77)
    pats = [bytes(random_dna(m, seed=80 + m)) for m in [10, 33]]
    want = mk_scanner(pats, 1, "single", n_dev=1).count(corpus).tolist()
    for strategy in ["database_over_devices", "patterns_over_devices"]:
        sc = mk_scanner(pats, 1, strategy)
        assert sc.count(corpus).tolist() == want, strategy
        assert sc.last_strategy == strategy


def test_boundary_straddling_matches():
    """A match across every shard seam: shard d owns starts [d*s, (d+1)*s),
    so a seam window is counted once, from its owner's staged halo."""
    needle = b"GATTACAGATTACA"
    corpus = random_dna(16_384, seed=5, alphabet=b"X").copy()  # no noise hits
    sc = mk_scanner([needle], 1, "database_over_devices")
    from apm_torch.models.pipeline import make_plan

    plan = make_plan(sc, len(corpus))
    s = strategies.shard_layout(plan, 8, sc.config.chunk_bytes).s
    assert s == 2048
    for d in range(1, 8):
        pos = d * s - len(needle) // 2
        corpus[pos : pos + len(needle)] = np.frombuffer(needle, np.uint8)
    want = count_matches(corpus, [needle], 1)
    assert sc.count(corpus).tolist() == want
    assert want[0] >= 7


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_shard_count_invariance(n_dev):
    corpus = random_dna(9000, seed=13)
    pats = [bytes(random_dna(20, seed=14))]
    sc = mk_scanner(pats, 2, "database_over_devices", n_dev=n_dev)
    assert len(sc.devices()) == n_dev
    assert sc.count(corpus).tolist() == count_matches(corpus, pats, 2)


def test_shards_in_chunks():
    """A shard wider than chunk_bytes is staged in chunks, each bounded by
    the shard's end: ownership stays exact."""
    corpus = random_corpus(40_000, seed=15)
    pat = random_pattern(30, seed=16)
    plant(corpus, pat, [1000, 9990, 10_230, 20_470, 30_700], k=1, seed=17)
    sc = mk_scanner([pat.tobytes()], 1, "database_over_devices", n_dev=3,
                    chunk_bytes=3072, engine="filter")
    from apm_torch.models.pipeline import make_plan

    layout = strategies.shard_layout(make_plan(sc, len(corpus)), 3, 3072)
    assert layout.per_shard > 1 and layout.s % layout.chunk_win
    assert sc.count(corpus).tolist() == count_matches(corpus, [pat], 1)


def test_sharded_filtration_with_plants():
    pat = random_pattern(50, seed=41)
    corpus = random_corpus(8000, seed=42)
    plant(corpus, pat, [300, 2100, 5000, 7400], k=2, seed=43)
    sc = mk_scanner([pat.tobytes()], 2, "database_over_devices", n_dev=4, engine="filter")
    want = count_matches(corpus, [pat], 2)
    assert sc.count(corpus).tolist() == want
    assert want[0] >= 4
    assert sc.last_filtration["route"] == "device-verify"


def test_sharded_dedup_filter_mixed():
    long_pat = random_pattern(50, seed=71)
    corpus = random_corpus(9000, seed=72)
    plant(corpus, long_pat, [100, 4500, 8800], k=1)
    pats = [long_pat, b"ACGTA", long_pat, b"ACGTA", long_pat]
    want = count_matches(corpus, pats, 1)
    got = mk_scanner(pats, 1, "database_over_devices", n_dev=4).count(corpus)
    assert got.tolist() == want
    jsc = jax_scanner(pats, 1, "database_over_devices", n_dev=4)
    assert jsc.count(corpus).tolist() == want


def test_patterns_over_devices_pipeline():
    """Mixed lengths, duplicates and planted matches over 8 pattern groups,
    each a whole single-device scan; a repeated scan reuses the cached
    sub-scanners."""
    corpus = random_dna(20_000, seed=171)
    p50 = random_pattern(50, seed=172)
    plant(corpus, p50, [1500, 9000, 17_500], k=1, seed=173)
    pats = [p50.tobytes()] + [bytes(random_dna(m, seed=180 + m)) for m in
                              [9, 12, 20, 20, 33, 41, 50, 64, 77, 100, 128]] + [p50.tobytes()]
    sc = mk_scanner(pats, 1, "patterns_over_devices", engine="filter")
    want = count_matches(corpus, pats, 1)
    assert sc.count(corpus).tolist() == want
    assert want[0] >= 3 and want[0] == want[-1]
    subs = sc._shard_scanners
    assert len(subs) == 8 and sc.count(corpus).tolist() == want
    assert sc._shard_scanners is subs


def test_patterns_share_one_host_fold(monkeypatch):
    """The groups' sub-scanners fold each chunk once between them, and hold
    no folded rows after the call."""
    from apm_torch.models import scanner as scanner_mod

    corpus = random_dna(20_000, seed=9)
    pats = [bytes(random_dna(40, seed=300 + i)) for i in range(4)]
    folds = []
    real = scanner_mod.fold_corpus
    monkeypatch.setattr(scanner_mod, "fold_corpus",
                        lambda *a, **kw: folds.append(a[1]) or real(*a, **kw))
    sc = mk_scanner(pats, 1, "patterns_over_devices", n_dev=4, engine="dp",
                    cache_corpus=True)
    assert sc.count(corpus).tolist() == count_matches(corpus, pats, 1)
    assert len(folds) == 1
    assert sc._shard_scanners[0]._fold_cache == {}  # released when the call returns


def test_pattern_groups_equal_apm():
    import apm
    from apm.parallel.strategies import _pattern_groups as jax_groups

    sets = [
        [bytes([65 + i]) * m for i, m in enumerate([100, 90, 10, 11, 12, 13, 50, 51])],
        [bytes(random_dna(m, seed=m)) for m in [5, 18, 50, 7, 7, 33, 120]],
    ]
    for pats in sets:
        tsc = apm_torch.Scanner(pats, 1, ApmConfig(device="cpu"))
        jsc = apm.Scanner(pats, 1, apm.ApmConfig(backend="pallas", interpret=True))
        for n_dev in (1, 2, 3, 4, 8, 16):
            assert strategies._pattern_groups(tsc, n_dev) == jax_groups(jsc, n_dev)
    groups = strategies._pattern_groups(apm_torch.Scanner(sets[0], 1, ApmConfig(device="cpu")), 16)
    assert len(groups) == 8 and all(len(g) == 1 for g in groups)


def test_auto_routing_equal_apm():
    """auto: one pattern per device routes to patterns_over_devices, one
    more to database; at k = 0 the correlation engine pins database. The
    port's last_strategy equals apm's on its 8 devices, and the counts the
    oracle's."""
    import jax

    n_dev = len(jax.devices())
    assert n_dev == 8
    corpus = random_dna(32 << 10, seed=41)
    pats = [bytes(random_dna(40, seed=300 + i)) for i in range(n_dev)]
    # apm's XLA engine routes k >= 1 as its Pallas route does, and faster
    # here; its k = 0 gate reads the Pallas plan
    cases = [(pats, 1, "patterns_over_devices", "xla"),
             (pats + [bytes(random_dna(40, seed=999))], 1, "database_over_devices", "xla")]
    corpus0 = random_dna(8 << 10, seed=53)
    pats0 = [bytes(random_dna(50, seed=400 + i)) for i in range(n_dev)]
    cases += [(pats0, 0, "database_over_devices", "pallas"),
              (pats0, 1, "patterns_over_devices", "xla")]
    for ps, k, want_strategy, backend in cases:
        c = corpus0 if ps is pats0 else corpus
        tsc = mk_scanner(ps, k, "auto")
        jsc = jax_scanner(ps, k, "auto", n_dev=None, backend=backend)
        want = count_matches(c, ps, k)
        assert tsc.count(c).tolist() == want
        assert jsc.count(c).tolist() == want
        assert tsc.last_strategy == jsc.last_strategy == want_strategy, (k, len(ps))


def test_one_device_runs_single():
    corpus = random_dna(5000, seed=3)
    pats = [bytes(random_dna(20, seed=4))]
    sc = mk_scanner(pats, 1, "database_over_devices", n_dev=1)
    assert sc.devices() == [CPU]
    assert sc.count(corpus).tolist() == count_matches(corpus, pats, 1)
    with pytest.raises(ValueError, match="unknown distribution strategy"):
        strategies.count_distributed(sc, corpus, "single", [CPU, CPU])


def test_packed_layout_equal_apm():
    """The shards' packed phase-2 vectors joined as apm's shard_map joins
    them (psum of the totals, all_gather of n_hot and the clipped starts),
    and split by both packages' _unpack_sharded alike."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from apm.parallel import strategies as jstrat

    p, n_dev = 8, 4
    rng = np.random.default_rng(0)
    width = 2 * p + 1 + tfused.MAX_CLIP
    packs = rng.integers(-1, 50, size=(n_dev, width)).astype(np.int32)
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("data",))
    jax_vec = np.asarray(jax.shard_map(
        lambda x: jstrat._collective_pack(x[0], p), mesh=mesh,
        in_specs=P("data", None), out_specs=P(None), check_vma=False,
    )(jnp.asarray(packs)))
    ours = strategies._collective_pack(list(packs), p, strategies.LocalComm(n_dev))
    assert ours.tolist() == jax_vec.tolist()
    for a, b in zip(strategies._unpack_sharded(ours, p, n_dev),
                    jstrat._unpack_sharded(jax_vec, p, n_dev)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("k,lengths,engine", [(0, [12, 50, 33], "auto"),
                                               (1, [24, 50], "auto"),
                                               (3, [40, 9], "filter")])
def test_counts_equal_apm_database(k, lengths, engine):
    """count_database_over_devices of both packages at a small size."""
    from apm.parallel.strategies import count_database_over_devices as jax_db

    corpus = random_corpus(7000, seed=60 + k)
    pats = [random_pattern(m, seed=61 + m) for m in lengths]
    plant(corpus, pats[0], [200, 3500, 6900], k=k, seed=62)
    pats = [p.tobytes() for p in pats]
    tsc = mk_scanner(pats, k, "auto", engine=engine)
    jsc = jax_scanner(pats, k, "auto", engine=engine)
    got = strategies.count_database_over_devices(tsc, corpus, [CPU] * 4)
    want = jax_db(jsc, corpus, 4)
    assert got.tolist() == np.asarray(want).tolist()
    assert got[: len(pats)].tolist() == count_matches(corpus, pats, k)


def _filter_case(n, every, seed=90):
    pat = random_pattern(48, seed=seed)
    short = random_pattern(6, seed=seed + 1)
    corpus = random_corpus(n, seed=seed + 2)
    plant(corpus, pat, range(300, n - 100, every), k=1, seed=seed + 3)
    return corpus, [short.tobytes(), pat.tobytes()]


@pytest.mark.parametrize(
    "n,every,max_hot,route",
    [
        (30_000, 29_000, None, "zero-candidates"),
        (30_000, 7000, None, "device-verify"),
        (30_000, 130, None, "rescan"),  # a plant in every row: density
        (120_000, 2900, 8, "verify_rows_host"),  # over the bucket, row maps fetched
    ],
)
def test_finalize_sharded_branches(monkeypatch, n, every, max_hot, route):
    """Each branch of finalize_filtration a sharded scan can take, forced
    by the plant density and MAX_HOT shrunk in both packages; the route is
    asserted and the counts equal apm's and the oracle's."""
    import apm.ops.fused as jfused

    from apm.parallel.strategies import count_database_over_devices as jax_db

    if max_hot is not None:
        monkeypatch.setattr(tfused, "MAX_HOT", max_hot)
        monkeypatch.setattr(jfused, "MAX_HOT", max_hot)
    corpus, pats = _filter_case(n, every)
    if route == "zero-candidates":
        corpus = random_corpus(n, seed=5)
    tsc = mk_scanner(pats, 1, "auto", engine="filter")
    got = strategies.count_database_over_devices(tsc, corpus, [CPU] * 4)
    assert tsc.last_filtration["route"] == route, tsc.last_filtration
    want = count_matches(corpus, pats, 1)
    assert got[:2].tolist() == want
    jsc = jax_scanner(pats, 1, "auto", engine="filter")
    assert np.asarray(jax_db(jsc, corpus, 4)).tolist() == got.tolist()


def test_finalize_overflow_without_rowmaps_rescans(monkeypatch):
    """Past one process no row map can be fetched: an overflowed bucket
    goes to the banded rescan (route "overflow-rescan"), as apm's
    multi-process scan does."""
    from apm_torch.models.pipeline import buf_reader, make_plan

    monkeypatch.setattr(tfused, "MAX_HOT", 8)
    corpus, pats = _filter_case(120_000, 2900)
    sc = mk_scanner(pats, 1, "auto", engine="filter")
    plan = make_plan(sc, len(corpus))
    layout = strategies.shard_layout(plan, 4, sc.config.chunk_bytes)
    stage = lambda rep, c0, n_rows: rep._staged_rows(corpus, None, c0, n_rows, plan.wf, plan.halo)
    got = strategies._count_shards(
        sc, plan, layout, [(d, sc) for d in range(4)], stage, strategies.LocalComm(4),
        buf_reader(corpus), len(corpus), single_proc=False,
    )
    got[:2] += sc.tail_counts(corpus, plan.dev_bound)
    assert sc.last_filtration["route"] == "overflow-rescan"
    assert got[:2].tolist() == count_matches(corpus, pats, 1)


def test_replica_scanners_carry_tables():
    """A shard on another device goes through a replica Scanner built once
    from the parent's tables (Scanner.tables / load_tables); "cpu:0" is a
    device other than "cpu" to the replica cache, the same memory to
    torch."""
    corpus = random_corpus(20_000, seed=21)
    pat = random_pattern(40, seed=22)
    plant(corpus, pat, [700, 9000, 15_000], k=2, seed=23)
    pats = [pat.tobytes(), b"ACGTACG"]
    sc = mk_scanner(pats, 2, "database_over_devices", n_dev=4)
    other = torch.device("cpu", 0)
    want = count_matches(corpus, pats, 2)
    for strategy in ("database_over_devices", "patterns_over_devices"):
        got = strategies.count_distributed(sc, corpus, strategy, [other, CPU, other, CPU])
        assert got[:2].tolist() == want, strategy
    rep = sc._replica_scanners[other]
    assert list(sc._replica_scanners) == [other] and rep.device == other
    for name, table in sc.tables().items():
        assert np.array_equal(rep.tables()[name], table), name
    strategies.count_distributed(sc, corpus, "database_over_devices", [other, CPU])
    assert sc._replica_scanners[other] is rep
