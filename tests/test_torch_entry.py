"""The port's ``entry()`` twin, kernel #9's plain version and the torch
reference engine, held against apm (Pallas in interpret mode, its XLA
engine) and the oracle.

- ``apm_torch.graft_entry.entry(device="cpu")`` against the repo's
  ``__graft_entry__.entry()`` on JAX-CPU (its XLA branch) and the oracle.
- ``apm_torch.ops.dp_kernel.scan_folded_ref`` (and ``scan_folded``, which
  takes it for CPU tensors) against
  ``apm.ops.pallas_kernel.scan_folded_pallas(interpret=True)``: dynamic
  lengths with padding rows and mixed lengths, k in {0, 1, 3}, ``start >
  0`` and a mid-row bound, on the TPU branch's staging of ``entry()``.
- ``apm_torch.ops.torch_engine.scan_corpus_torch`` against
  ``apm.ops.xla_engine.scan_corpus_xla`` and the oracle.

Every output is an integer count: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from apm.utils.oracle import banded_distances, count_matches

from apm_torch import graft_entry
from apm_torch.ops import dp_kernel
from apm_torch.ops.common import fold_corpus, pad_corpus, round_up
from apm_torch.ops.torch_engine import scan_corpus_torch


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


def _tables(pats, k, p_pad=8):
    from apm_torch.utils.io import PatternSet

    ps = PatternSet.from_patterns(pats)
    pat, plen = ps.packed(k)
    pat8 = np.zeros((p_pad, pat.shape[1]), np.uint8)
    pat8[: pat.shape[0]] = pat
    plen8 = np.zeros((p_pad,), np.int32)
    plen8[: plen.shape[0]] = plen
    return pat8, plen8, ps.max_len


def test_entry_cpu_matches_graft_entry_and_oracle():
    import jax

    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(*jargs)).tolist()
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    assert got.dtype == torch.int32 and got.shape == (8,)
    assert got.tolist() == want
    oracle = count_matches(graft_entry.example_corpus(), list(graft_entry.PATTERNS), graft_entry.K)
    assert got.tolist()[:2] == oracle and sum(oracle) > 0
    assert np.array_equal(np.asarray(jargs[0]), args[0].numpy())  # the same padded corpus


def test_entry_tpu_branch_staging_matches_apm():
    """The staging entry() builds for the card equals apm's TPU branch
    (``__graft_entry__.py:32-56``), and the plain version of kernel #9 over
    it equals apm's kernel in interpret mode and the oracle over the
    device-owned windows."""
    import jax.numpy as jnp

    from apm.ops.common import fold_corpus as jfold
    from apm.ops.pallas_kernel import scan_folded_pallas

    corpus = graft_entry.example_corpus()
    pat8, plen8, m_max = graft_entry.example_tables()
    k, n = graft_entry.K, len(corpus)
    wf, halo = graft_entry.W // 8, round_up(m_max, 128)
    bound = max(0, min(n - m_max + 1, n - k))
    n_rows = max(8, round_up(-(-bound // wf), 8))
    rows = fold_corpus(corpus, 0, n_rows, wf, halo)
    assert np.array_equal(rows, jfold(corpus, 0, n_rows, wf, halo))
    want = np.asarray(scan_folded_pallas(
        jnp.asarray(rows), jnp.asarray(pat8), jnp.asarray(plen8),
        jnp.asarray(bound, jnp.int32), jnp.asarray(0, jnp.int32),
        k=k, m_max=m_max, wf=wf, halo=halo, interpret=True,
    )).tolist()
    got = dp_kernel.scan_folded(
        torch.from_numpy(rows), torch.from_numpy(pat8), torch.from_numpy(plen8),
        torch.tensor(bound, dtype=torch.int32), torch.tensor(0, dtype=torch.int32),
        k=k, m_max=m_max, wf=wf, halo=halo,
    )
    assert got.tolist() == want
    owned = [int((banded_distances(corpus, p, k)[:bound] <= k).sum()) for p in graft_entry.PATTERNS]
    assert got.tolist()[:2] == owned and sum(owned) > 0


@pytest.mark.parametrize("k", [0, 1, 3])
def test_scan_folded_ref_matches_pallas_dynamic_lengths(k):
    import jax.numpy as jnp

    from apm.ops.pallas_kernel import scan_folded_pallas

    wf, n_rows = 256, 16
    c = _corpus(20 * wf, 40 + k, b"ACGT")
    pats = [bytes(c[100:130]), bytes(c[1500:1541]), b"ACGTTGCA", bytes(c[3000:3012])]
    for pos in range(200, len(c) - 50, 700):  # copies, some with one substitution
        c[pos : pos + 41] = np.frombuffer(pats[1], np.uint8)
        c[pos + 20] ^= (pos // 700) % 2
    pat8, plen8, m_max = _tables(pats, k)
    halo = round_up(m_max + 2 * k, 128)
    start = 2 * wf
    rows = fold_corpus(c, start, n_rows, wf, halo)
    bound = start + (n_rows - 3) * wf + 77  # mid-row
    for plen in (plen8, np.array([0, 41, 8, 0, 12, 0, 0, 0], np.int32)):  # rows moved
        want = np.asarray(scan_folded_pallas(
            jnp.asarray(rows), jnp.asarray(pat8), jnp.asarray(plen),
            jnp.asarray(bound, jnp.int32), jnp.asarray(start, jnp.int32),
            k=k, m_max=m_max, wf=wf, halo=halo, interpret=True,
        )).tolist()
        args = (torch.from_numpy(rows), torch.from_numpy(pat8), torch.from_numpy(plen))
        got = dp_kernel.scan_folded_ref(*args, bound, start, k=k, m_max=m_max, wf=wf, halo=halo)
        wrapped = dp_kernel.scan_folded(*args, bound, start, k=k, m_max=m_max, wf=wf, halo=halo)
        assert got.tolist() == wrapped.tolist() == want
        assert sum(want) > 0


def test_scan_folded_checks_its_inputs():
    rows = torch.zeros((8, 256), dtype=torch.uint8)
    pat = torch.zeros((8, 12), dtype=torch.uint8)
    kw = dict(k=1, m_max=10, wf=128, halo=128)
    plen = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        dp_kernel.scan_folded(rows[:6], pat, plen, 100, 0, **kw)
    with pytest.raises(ValueError, match="plen"):
        dp_kernel.scan_folded(rows, pat, plen[:7], 100, 0, **kw)
    with pytest.raises(ValueError, match=r"\[0, 10\]"):
        dp_kernel.scan_folded(rows, pat, plen + 11, 100, 0, **kw)
    before = dp_kernel.DYN_LAUNCHES
    assert dp_kernel.scan_folded(rows, pat, plen, 100, 0, **kw).tolist() == [0] * 8
    assert dp_kernel.DYN_LAUNCHES == before


@pytest.mark.parametrize("k", [0, 1, 2])
def test_scan_corpus_torch_matches_xla_and_oracle(k):
    import jax.numpy as jnp

    from apm.ops.xla_engine import scan_corpus_xla

    v = 256
    c = _corpus(3000, 60 + k)
    pats = [bytes(c[100:113]), b"ACGTT", bytes(c[2985:])]  # an EOF-truncated match
    pat8, plen8, m_max = _tables(pats, k)
    n = len(c)
    buf = pad_corpus(c, max(round_up(max(n - k, 0), v), v), m_max)
    want = np.asarray(scan_corpus_xla(
        jnp.asarray(buf), jnp.asarray(pat8), jnp.asarray(plen8), jnp.asarray(n, jnp.int32),
        jnp.asarray(0, jnp.int32), k=k, m_max=m_max, v=v,
    )).tolist()
    got = scan_corpus_torch(
        torch.from_numpy(buf), torch.from_numpy(pat8), torch.from_numpy(plen8),
        torch.tensor(n, dtype=torch.int32), 0, k=k, m_max=m_max, v=v,
    )
    assert got.dtype == torch.int32 and got.tolist() == want
    assert want[:3] == count_matches(c, pats, k) and want[2] >= 1
