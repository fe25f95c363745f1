"""The port's dry run, fuzz and CLI strategy word, on the CPU.

* ``apm_torch.graft_entry.dryrun_multichip`` on 8 logical CPU devices (its
  default without a card) and on 3: every sharded case against the oracle,
  as ``__graft_entry__.dryrun_multichip`` checks ``apm``'s.
* ``apm_torch.utils.fuzz.run_fuzz`` on the CPU: 9 trials, one per ``POOL``
  entry, 64 KB each; every check against the NumPy oracle.
* The CLI's trailing strategy word sets the strategy: ``DB_OVER_RANKS`` and
  ``PATTERNS_OVER_RANKS`` with ``--devices 4 --device cpu`` print lines
  byte-identical to ``python -m apm`` with the same word (4 virtual JAX
  devices), the time line aside, and the scan's stats line names the
  strategy.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from apm_torch.graft_entry import dryrun_multichip
from apm_torch.utils import fuzz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("devices", [None, ["cpu"] * 3])
def test_dryrun_multichip_on_cpu(devices):
    dryrun_multichip(devices)


def test_dryrun_needs_two_devices():
    with pytest.raises(AssertionError, match="more than one device"):
        dryrun_multichip(["cpu"])


def test_fuzz_one_trial_per_pool_entry():
    res = fuzz.run_fuzz(len(fuzz.POOL), seed=0, device="cpu", max_bytes=64 << 10)
    assert res.mismatch is None, res.mismatch
    assert res.passed == len(fuzz.POOL) == 9
    assert res.checks == {"count": 9, "find": 2, "count_batch": 2, "database_over_devices": 3}


def test_fuzz_trials_follow_the_pool():
    """Trial i draws POOL[i % 9], a corpus in the size range, read-only."""
    trials = fuzz.draw_trials(4, seed=7, max_bytes=80 << 10)
    assert [(t.k, t.plens, t.alphabet) for t in trials] == [e for e in fuzz.POOL[:4]]
    assert all(64 << 10 <= len(t.corpus) <= 80 << 10 for t in trials)
    assert not trials[0].corpus.flags.writeable
    assert set(np.unique(trials[2].corpus).tobytes()) <= set(b"ACGT\n")


def _cli(module, args, env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", APM_COMPILE_CACHE="", **env_extra)
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)


@pytest.mark.parametrize(
    "word,strategy",
    [("DB_OVER_RANKS", "database_over_devices"), ("PATTERNS_OVER_RANKS", "patterns_over_devices")],
)
def test_cli_strategy_word_matches_apm(tmp_path, word, strategy):
    rng = np.random.default_rng(8)
    c = np.frombuffer(b"ACGT\n", np.uint8)[rng.integers(0, 5, size=30_000)]
    c[7000:7112] = np.frombuffer(b"GATTACA" * 16, np.uint8)
    path = str(tmp_path / "db.fa")
    c.tofile(path)
    args = ["1", path, "GATTACA" * 16, "ACGTTG", "GATTACAGAT", "TTTTTT", word, "--devices", "4"]
    j = _cli("apm", args, {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    t = _cli("apm_torch", args + ["--device", "cpu", "--verbose"], {})
    assert j.returncode == 0, j.stderr
    assert t.returncode == 0, t.stderr
    sans = lambda out: [l for l in out.splitlines() if not l.startswith("APM done in ")]
    assert sans(t.stdout) == sans(j.stdout)
    assert f"<{'GATTACA' * 14}GA>" in t.stdout  # the parallel variant's 100-char echo
    assert f"[{strategy}/torch" in t.stderr


def test_fuzz_command_line(capsys):
    assert fuzz.main(["--trials", "2", "--device", "cpu", "--max-bytes", str(64 << 10),
                      "--workers", "2"]) == 0
    assert "2 fuzz trials passed on cpu" in capsys.readouterr().out
