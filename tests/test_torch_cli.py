"""The port's CLI against apm's: identical output apart from the time line."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["APM_COMPILE_CACHE"] = ""  # no persistent compile cache for apm
    env.pop("XLA_FLAGS", None)
    extra = ("--device", "cpu") if module == "apm_torch" else ()
    return subprocess.run(
        [sys.executable, "-m", module, *args, *extra],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )


def _sans_timing(stdout):
    return [l for l in stdout.splitlines() if not l.startswith("APM done in ")]


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    c = np.frombuffer(b"ACGT\n", np.uint8)[rng.integers(0, 5, size=20_000)]
    c[4_000:4_120] = np.frombuffer(b"GATTACA" * 17 + b"G", np.uint8)
    path = tmp_path_factory.mktemp("cli") / "db.fa"
    c.tofile(path)
    return str(path)


@pytest.mark.parametrize(
    "args",
    [
        ("0", "GATTACA", "ACGTA", "GATTACA"),
        ("1", "GATTACAGATT", "TTTTTT"),
        ("0", "GATTACA" * 16, "ACG", "DB_OVER_RANKS"),  # 112 chars: echo cut
        ("0", "GATTACA" * 16, "ACG", "DB_OVER_RANKS", "--no-truncate-echo"),
    ],
)
def test_cli_output_matches_apm(corpus_file, args):
    k, *rest = args
    j = _run("apm", k, corpus_file, *rest)
    t = _run("apm_torch", k, corpus_file, *rest)
    assert j.returncode == 0, j.stderr
    assert t.returncode == 0, t.stderr
    assert _sans_timing(t.stdout) == _sans_timing(j.stdout)
    assert any(l.startswith("APM done in ") and l.endswith(" s")
               for l in t.stdout.splitlines())


def test_cli_errors_match_apm(corpus_file):
    for args in (("0",), ("x", corpus_file, "ACGT"), ("0", "/nonexistent/db.fa", "ACGT")):
        j, t = _run("apm", *args), _run("apm_torch", *args)
        assert (t.returncode, t.stdout, t.stderr) == (j.returncode, j.stdout, j.stderr)
