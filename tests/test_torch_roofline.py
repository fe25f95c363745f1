"""apm_torch.utils.roofline (port of tests/test_roofline.py): the H100's
peaks, the per-byte models, their shares, the Scanner's engine split held
against apm.utils.roofline's, and the kernel-bound counters that
chip_smoke.py takes from the module.

The shares are floats computed from exact integer counts and the peaks;
the comparisons with the peaks allow 1e-12 for float rounding. Counts are
integers: tolerance 0.
"""

import os
import sys

import numpy as np
import pytest
import torch

import apm
import apm.utils.roofline as jroof
from apm import ApmConfig as JaxConfig

import apm_torch
import apm_torch.utils.roofline as roof
from apm_torch import ApmConfig
from apm_torch.models.pipeline import make_plan
from apm_torch.ops.common import fold_corpus
from apm_torch.utils.io import PatternSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64 << 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the test workers share the machine's cores; torch's own thread pool in
    # each would oversubscribe them and slow every worker down
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pat(m, seed, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    return bytes(np.frombuffer(alphabet, np.uint8)[rng.integers(0, len(alphabet), m)])


def test_peaks_are_the_h100s():
    assert roof.PEAK_HBM == 3.35e12
    assert roof.PEAK_INT_ISSUE == 132 * 128 * 1.98e9
    assert roof.PEAK_TC_TF32 == 495e12
    # no TPU figure or calibration is carried over
    for name in ("PEAK_MXU_BF16", "PEAK_VPU_IOPS", "ENC_OPS_PER_ELEM", "FUSED_OPS_PER_BYTE"):
        assert not hasattr(roof, name)


def test_band_model_scales_with_k_and_m():
    a = roof.band_model([50], 1)
    b = roof.band_model([50], 4)
    assert b.int_instr / a.int_instr == (2 * 4 + 1) / (2 * 1 + 1)
    assert roof.band_model([100], 1).int_instr == 2 * a.int_instr
    assert a.int_instr == 50 * 3 * roof.BAND_CELL_INSTR
    assert a.binding == "int" and a.tc_flops == 0.0 and a.hbm_bytes == 1.0
    # past the pattern's length the band stops growing (min(k, m) a side)
    assert roof.band_model([10], 40).int_instr == roof.band_model([10], 10).int_instr
    assert roof.band_model([10, 0, 0], 3).int_instr == roof.band_model([10], 3).int_instr


def test_myers_model_independent_of_k_past_the_pair_limit():
    # one window a step past 2k + 1 = 15: 18 static, 21 moving a step, no
    # (2k + 1) factor; at or below it two windows share an update
    per_k = [roof.myers_model([50], k).int_instr for k in range(8, 15)]
    assert all(50 * 18 <= v <= 50 * 21 for v in per_k)
    assert per_k == sorted(per_k, reverse=True)  # static steps are cheaper
    assert per_k[-1] / per_k[0] > 0.95
    paired = roof.myers_model([50], 7).int_instr
    assert paired == (7 * 20 + 43 * 23) / 2
    assert roof.myers_model([50], 7).binding == "int"


def test_corr_model_counts_the_conv():
    # 6 patterns of 50 bytes, DNA: B = 2 +-1 planes
    m = roof.corr_model(6, 50, 4)
    assert m.tc_flops == 2 * 6 * 50 * 2
    assert m.int_instr == 6 * roof.COMPARE_OPS
    assert m.hbm_bytes == 1 + 8 * 2
    assert m.binding == "hbm"
    assert m.roof_bytes_per_s() == roof.PEAK_HBM / 17


def test_mfu_fractions_consistent():
    m = roof.corr_model(64, 50, 5)
    f = m.mfu(2.2e9)
    assert abs(f["mfu_tc"] - m.tc_flops * 2.2e9 / roof.PEAK_TC_TF32) < 1e-12
    assert abs(f["mfu_int"] - m.int_instr * 2.2e9 / roof.PEAK_INT_ISSUE) < 1e-12
    assert abs(f["hbm_frac"] - m.hbm_bytes * 2.2e9 / roof.PEAK_HBM) < 1e-12
    assert 0 < f["mfu_tc"] < 1 and 0 < f["mfu_int"] < 1 and 0 < f["hbm_frac"] < 1
    assert f["roof_mb_per_s"] == m.roof_bytes_per_s() / 1e6
    # at the roof the binding unit's share is 1
    at_roof = m.mfu(m.roof_bytes_per_s())
    assert abs(max(at_roof["mfu_int"], at_roof["mfu_tc"], at_roof["hbm_frac"]) - 1.0) < 1e-12


def test_mfu_fields_keys_and_rounding():
    sc = apm_torch.Scanner([_pat(32, 1), _pat(50, 2)], 0, ApmConfig(device="cpu"))
    f = roof.mfu_fields(sc, N, 2.0e9)
    assert set(f) == {"mfu_int", "mfu_tc", "hbm_frac", "binding", "roof_mb_per_s"}
    full = roof.model_for_scanner(sc, N).mfu(2.0e9)
    assert f["mfu_int"] == round(full["mfu_int"], 4)
    assert f["roof_mb_per_s"] == round(full["roof_mb_per_s"], 1)


def test_mfu_fields_empty_on_zero_throughput():
    sc = apm_torch.Scanner([_pat(50, 3)], 0, ApmConfig(device="cpu"))
    assert roof.mfu_fields(sc, N, 0.0) == {}
    # no device-owned window: the host counts the scan, no model
    assert roof.model_for_scanner(sc, 30) is None
    assert roof.mfu_fields(sc, 30, 1e9) == {}


SHORT = [_pat(12, 10), _pat(20, 11)]
REFERENCE = [_pat(32, 12)] + [_pat(50, 13)] * 5


@pytest.mark.parametrize("corr_impl", ["auto", "fused", "conv"])
@pytest.mark.parametrize("k", [0, 1, 2, 3, 8, 12])
@pytest.mark.parametrize("pats", [SHORT, REFERENCE], ids=["short", "reference"])
def test_model_for_scanner_engine_split_matches_apm(pats, k, corr_impl):
    # The same engines contribute as in apm's model. apm's vector work is
    # the port's integer work. apm's matrix work comes from its correlation
    # engines (the k = 0 set, conv phase 1); the port runs those as conv1d
    # on the tensor cores where its routes take the conv, and as byte
    # compares (kernels B and #7, integer work) where they take the fused
    # kernels. The values differ: the peaks and counts are the card's.
    tsc = apm_torch.Scanner(pats, k, ApmConfig(device="cpu", corr_impl=corr_impl))
    jsc = apm.Scanner(pats, k, JaxConfig(corr_impl=corr_impl))
    tm = roof.model_for_scanner(tsc, N)
    jm = jroof.model_for_scanner(jsc, N)
    assert (tm is None) == (jm is None)
    plan_routes = make_plan(tsc, N).routes
    routes = {plan_routes.corr, plan_routes.fp1} - {None}
    assert (tm.int_instr > 0) == (jm.vpu_ops > 0)
    assert (tm.tc_flops > 0) == ("conv" in routes)
    assert (jm.mxu_flops > 0) == bool(routes)
    assert tm.binding in ("int", "tc", "hbm") and tm.hbm_bytes >= 1.0


def test_model_for_scanner_counts_each_route():
    n_ref = 2  # the reference set's distinct patterns
    sc = apm_torch.Scanner(REFERENCE, 0, ApmConfig(device="cpu"))
    assert roof.model_for_scanner(sc, N) == roof.fused_corr_model(n_ref)  # kernel B
    sc = apm_torch.Scanner(REFERENCE, 0, ApmConfig(device="cpu", corr_impl="conv"))
    assert roof.model_for_scanner(sc, N) == roof.corr_model(n_ref, 50, 4)
    sc = apm_torch.Scanner(SHORT, 0, ApmConfig(device="cpu"))  # kernel D, 1 piece each
    assert roof.model_for_scanner(sc, N) == roof.fused_corr_model(2)
    # k = 3: kernel D, 4 exact pieces a pattern; the rescan is not counted
    sc = apm_torch.Scanner(REFERENCE, 3, ApmConfig(device="cpu"))
    assert roof.model_for_scanner(sc, N).int_instr == 8 * roof.COMPARE_OPS
    # k = 1: the piece conv (4 pieces, the longest 25 bytes), or kernel #7
    sc = apm_torch.Scanner(REFERENCE, 1, ApmConfig(device="cpu"))
    assert roof.model_for_scanner(sc, N) == roof.corr_model(4, 25, 4)
    sc = apm_torch.Scanner(REFERENCE, 1, ApmConfig(device="cpu", corr_impl="fused"))
    assert roof.model_for_scanner(sc, N) == roof.fused_corr_model(4)
    # k = 12: the Myers band on six 50-mers; k = 2 on the short set: the band
    fifty = [_pat(50, 20 + i) for i in range(6)]
    sc = apm_torch.Scanner(fifty, 12, ApmConfig(device="cpu"))
    assert roof.model_for_scanner(sc, N) == roof.myers_model([50] * 6, 12)
    sc = apm_torch.Scanner(SHORT, 2, ApmConfig(device="cpu"))
    assert roof.model_for_scanner(sc, N) == roof.band_model([12, 20], 2)


def test_model_for_scanner_leaves_out_apms_fused_piece_defect():
    # apm gates its fused-piece model on the k = 0 count gate (m <= 97,
    # apm/utils/roofline.py:209) and so raises for k >= 1 at 65 < m_max <=
    # 97, where the scan itself runs the piece conv; the port follows the
    # route the scan takes
    pats = [_pat(80, 30), _pat(72, 31)]
    jsc = apm.Scanner(pats, 1, JaxConfig())
    with pytest.raises(AssertionError):  # build_fused_piece_tables: m <= 65
        jroof.model_for_scanner(jsc, N)
    for corr_impl in ("auto", "fused"):
        tsc = apm_torch.Scanner(pats, 1, ApmConfig(device="cpu", corr_impl=corr_impl))
        assert make_plan(tsc, N).routes.fp1 == "conv"
        assert roof.model_for_scanner(tsc, N) == roof.corr_model(4, 40, 4)


def test_model_for_scanner_raises_where_the_scan_would():
    # no bare except: a plan the scan refuses raises here too
    sc = apm_torch.Scanner([_pat(120, 40)], 0, ApmConfig(device="cpu", corr_impl="fused"))
    with pytest.raises(ValueError):
        sc.count(np.frombuffer(_pat(4096, 41), np.uint8))
    with pytest.raises(ValueError):
        roof.model_for_scanner(sc, N)


def test_chip_smoke_takes_its_bounds_from_the_module():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    names = ["PEAK_HBM", "PEAK_INT_ISSUE", "COMPARE_OPS", "BAND_CELL_INSTR",
             "MYERS_STATIC_STEP_INSTR", "MYERS_MOVING_STEP_INSTR",
             "MYERS_PAIR_STATIC_STEP_INSTR", "MYERS_PAIR_MOVING_STEP_INSTR",
             "band_instr", "myers_instr", "compare_ops", "filter_ops", "mfu_fields"]
    for name in names:
        assert getattr(chip_smoke, name) is getattr(roof, name), name


def _rows():
    rng = np.random.default_rng(7)
    c = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 16 * 256 + 512)]
    c[1000:1100] = ord("A")
    limits = np.clip(14 * 256 + 100 - np.arange(16) * 256, 0, 256)
    return c, torch.from_numpy(fold_corpus(c, 0, 16, 256, 128)), limits


def _raw(pats):
    ps = PatternSet.from_patterns(pats)
    raw = np.zeros((8, ps.max_len), np.uint8)
    raw[: len(pats)] = ps.table
    return raw, tuple(len(p) for p in pats) + (0,) * (8 - len(pats))


def test_counters_give_the_integers_chip_smoke_counted():
    # the values chip_smoke.py's own counters gave on these inputs before
    # they moved into the module
    assert roof.band_instr(1000, (32, 50, 0), 1) == 492000
    assert roof.band_instr(777, (3, 9, 20), 12) == 1075368
    assert roof.myers_instr(1000, (50,) * 6, 12) == 6084000
    assert roof.myers_instr(1001, (32, 50), 3) == 934934
    assert roof.myers_instr(999, (5, 40), 7) == 499000
    c, rows, limits = _rows()
    pats = [bytes(c[500:520]), b"AAAAAAAA", bytes(c[3000:3031])]
    seqs = [(np.frombuffer(p, np.uint8), 0) for p in pats]
    assert roof.compare_ops(rows, seqs, limits, 256) == 45816
    assert roof.compare_ops(rows, [(np.frombuffer(b"ACGTAC", np.uint8), 5)], limits, 256,
                            width=256 + 64) == 14742
    for k, pats, want in (
        (0, [bytes(c[500:520]), b"AAAAAAAA", bytes(c[3000:3031])], 45711),
        (1, [bytes(c[500:520]), b"A" * 16, bytes(c[3000:3031])], 91668),
        (3, [bytes(c[500:532]), b"A" * 40], 126780),
        (8, [bytes(c[2000:2080]), b"A" * 80], 162414),  # the banded tier
    ):
        raw, plens = _raw(pats)
        assert roof.filter_ops(rows, raw, plens, k, limits, 256) == want, k
