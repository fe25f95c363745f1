"""The port's multi-process scan, ``count_multihost``, on the CPU.

Single-process: the file's shards on ``max_devices`` logical CPU devices,
without a process group. Two processes: this file re-run as its worker
(``python tests/test_torch_multihost.py PORT RANK WORLD PATH K OUT
PATTERN...``), each process with 4 logical CPU devices, joined by
``torch.distributed`` under ``gloo`` over localhost, 8 shards in all.
Counts are integers and must equal the oracle's (tolerance 0) on every
process. The worker records how often ``finalize_filtration``'s rescan
ran, so a test asserts which recovery branch a scan took.
``APM_TEST_MAXHOT`` shrinks the hot-row bucket (``fused.MAX_HOT``) so a
small corpus overflows it.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(argv) -> None:
    port, rank, world, path, k, out = argv[:6]
    patterns = [p.encode("latin-1") for p in argv[6:]]
    torch.set_num_threads(1)
    from apm_torch import ApmConfig, Scanner
    from apm_torch.models import pipeline
    from apm_torch.ops import fused
    from apm_torch.parallel import multihost

    if os.environ.get("APM_TEST_MAXHOT"):
        fused.MAX_HOT = int(os.environ["APM_TEST_MAXHOT"])
    rescans = {"n": 0}
    finalize = pipeline.finalize_filtration

    def spy(scanner, reader, plan, n, chunks, rescan, **kw):
        def counted():
            rescans["n"] += 1
            return rescan()

        return finalize(scanner, reader, plan, n, chunks, counted, **kw)

    pipeline.finalize_filtration = spy
    multihost.initialize(f"localhost:{port}", int(world), int(rank), backend="gloo", timeout=120)
    try:
        sc = Scanner(patterns, int(k), ApmConfig(device="cpu", max_devices=4, engine="filter",
                                                 block_windows=1024))
        counts = multihost.count_multihost(sc, path)
        with open(out, "w") as f:
            json.dump({
                "rank": int(rank),
                "world": torch.distributed.get_world_size(),
                "counts": [int(c) for c in counts[sc._inverse]],
                "rescan_calls": rescans["n"],
                "route": (sc.last_filtration or {}).get("route"),
                "devices": [str(d) for d in multihost.local_devices(sc)],
            }, f)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    _worker(sys.argv[1:])
    sys.exit(0)


import apm_torch  # noqa: E402
from apm_torch import ApmConfig  # noqa: E402
from apm_torch.parallel import multihost  # noqa: E402
from apm_torch.utils.corpus import plant, random_corpus, random_pattern  # noqa: E402
from apm_torch.utils.oracle import count_matches  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _file(tmp_path, data) -> str:
    path = str(tmp_path / "corpus.fa")
    data.tofile(path)
    return path


@pytest.mark.parametrize("k", [0, 2])
def test_single_process_vs_oracle_and_count(tmp_path, k):
    data = random_corpus(9000, seed=55)
    pats = [random_pattern(m, seed=70 + m).tobytes() for m in (10, 33, 50)]
    plant(data, np.frombuffer(pats[2], np.uint8), [500, 4100, 8900], k=k, seed=56)
    path = _file(tmp_path, data)
    sc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", max_devices=4, block_windows=1024))
    got = multihost.count_multihost(sc, path)[: len(pats)].tolist()
    assert got == count_matches(data, pats, k)
    assert got == sc.count(data).tolist()
    assert got[2] >= 3
    # apm's own count_multihost, one process over its 8 virtual devices
    import apm
    from apm.parallel.multihost import count_multihost as jax_multihost

    jsc = apm.Scanner(pats, k, apm.ApmConfig(backend="pallas", interpret=True, block_windows=1024))
    assert got == [int(c) for c in jax_multihost(jsc, path)[: len(pats)]]


def test_local_devices_per_rank(monkeypatch):
    """Under nccl each of two processes stages only on its own card (the
    one ``initialize`` set current); without a group, and under gloo (the
    two-process tests below), on ``scanner.devices()``."""
    import torch.distributed as dist

    sc = apm_torch.Scanner([b"ACGTACGTAC"], 0, ApmConfig(device="cpu", max_devices=4))
    assert multihost.local_devices(sc) == [torch.device("cpu")] * 4
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    for rank in range(2):
        monkeypatch.setattr(torch.cuda, "current_device", lambda: rank)
        assert multihost.local_devices(sc) == [torch.device("cuda", rank)]


def test_single_process_filtration_rowmaps(tmp_path, monkeypatch):
    """One process holds every shard: an overflowed bucket is verified from
    host-staged rows found through the lazily fetched row maps, read back
    from the file."""
    from apm_torch.ops import fused

    monkeypatch.setattr(fused, "MAX_HOT", 8)
    data = random_corpus(120_000, seed=91)
    pat = random_pattern(48, seed=92)
    plant(data, pat, range(300, len(data) - 100, 2900), k=1, seed=93)
    path = _file(tmp_path, data)
    sc = apm_torch.Scanner([pat.tobytes()], 1, ApmConfig(device="cpu", max_devices=4,
                                                         engine="filter", block_windows=1024))
    got = multihost.count_multihost(sc, path)[:1].tolist()
    assert sc.last_filtration["route"] == "verify_rows_host"
    assert got == count_matches(data, [pat], 1)


def _two_procs(tmp_path, data, k, patterns, extra_env=None):
    path = _file(tmp_path, data)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, **(extra_env or {}))
    env.pop("XLA_FLAGS", None)
    outs = [str(tmp_path / f"out{i}.json") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(port), str(i), "2", path,
             str(k), outs[i]] + [p.decode("latin-1") for p in patterns],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    assert [r["world"] for r in results] == [2, 2]
    assert [r["devices"] for r in results] == [["cpu"] * 4] * 2  # gloo: every logical device
    return results


@pytest.mark.parametrize("k", [1, 3])
def test_two_processes(tmp_path, k):
    data = random_corpus(16_000, seed=131)
    pat = random_pattern(24, seed=132)
    plant(data, pat, [400, 2900, 5200, 9100, 15_000], k=k, seed=133)
    want = count_matches(data, [pat], k)
    assert want[0] >= 5
    for res in _two_procs(tmp_path, data, k, [pat.tobytes()]):
        assert res["counts"] == want, res


def test_two_processes_mixed_overflow_rescan(tmp_path):
    """k = 2, a short pattern on the DP route and a filtration pattern with
    one shard past the shrunk bucket: no process can fetch the row maps,
    so finalize_filtration must recover through the collective rescan."""
    k = 2
    data = random_corpus(40_000, seed=141)
    short = random_pattern(6, seed=142)
    elig = random_pattern(48, seed=143)
    plants0 = [200 + r * 128 for r in range(12)]  # 12 hot rows in shard 0
    plants_rest = [17_000 + r * 128 for r in range(5)] + [36_000, 38_000]
    plant(data, elig, plants0 + plants_rest, k=k, seed=144)
    pats = [short.tobytes(), elig.tobytes()]
    want = count_matches(data, pats, k)
    assert want[1] >= 19
    for res in _two_procs(tmp_path, data, k, pats, {"APM_TEST_MAXHOT": "8"}):
        assert res["counts"] == want, res
        assert res["rescan_calls"] == 1 and res["route"] == "overflow-rescan", res


def test_two_processes_banded_tier(tmp_path):
    """k = 6: the banded piece tier of a 64-byte pattern beside a short
    pattern on the DP route, across the process boundary."""
    k = 6
    data = random_corpus(12_000, seed=151)
    short = random_pattern(10, seed=152)
    banded = random_pattern(64, seed=153)
    plant(data, banded, [500, 5200, 11_000], k=k, seed=154)
    pats = [short.tobytes(), banded.tobytes()]
    want = count_matches(data, pats, k)
    assert want[1] >= 3
    for res in _two_procs(tmp_path, data, k, pats):
        assert res["counts"] == want, res


def test_initialize_failure_raises():
    """A bootstrap that cannot reach its coordinator raises; nothing is
    swallowed and no group is left behind."""
    import torch.distributed as dist

    with pytest.raises(dist.DistError):
        multihost.initialize(f"localhost:{_free_port()}", 2, 1, backend="gloo", timeout=2)
    assert not dist.is_initialized()
