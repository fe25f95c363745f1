"""Roofline / MFU accounting on an NVIDIA H100 (port of
``apm/utils/roofline.py``).

Every engine of a scan gets a model of the work it needs per corpus byte
(one window start), and a measured corpus throughput converts into the
share of the card's peak that work reaches. ``apm``'s shares are
``mfu_vpu`` and ``mfu_mxu``, against a TPU's vector unit and matrix unit;
the card has neither, so the port's are named for its own units:

* ``mfu_int``: integer instructions over the issue peak
  (:data:`PEAK_INT_ISSUE`);
* ``mfu_tc``: the conv routes' FLOPs over the tensor cores' TF32 peak
  (:data:`PEAK_TC_TF32`);
* ``hbm_frac``: device-memory bytes over :data:`PEAK_HBM`.

The models count the work, whatever implements it, at the fewest
instructions the card needs: each is a lower bound on what any
implementation must do, so a measured share never reads above 1, and a
reading above 1 means the model credits work the call did not need. They
count one pass of the plan's kernels over the corpus: no phase-2
verification and no density rescan (work beyond the plan, as in ``apm``).

Two levels of the same counts:

* **Kernel bounds** (``chip_smoke.py``'s ``bound_ms``): :func:`band_instr`,
  :func:`myers_instr`, :func:`compare_ops` and :func:`filter_ops` count the
  work of one launch on its staged rows. ``compare_ops`` counts an exact
  scan's early-exit compares (each pattern or piece compared with the text
  up to its first mismatch), which depends on the data.
* **Per-byte models** (:class:`OpsModel`, :func:`model_for_scanner`,
  :func:`mfu_fields`): the same rules at one owned window, with no corpus.
  An exact scan's model is its data-independent floor, one compare per
  pattern or piece and position; the early exits past the first byte are
  left out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

# The H100 SXM part's published peaks at its 700 W limit. The memory
# rate is 3.35 TB/s. The integer issue rate: each of an SM's four
# schedulers issues one 32-lane instruction per clock, so 132 SMs x 128
# lanes x 1.98 GHz boost clock (the float32 row of the card's table, 67
# TFLOP/s, is the same issue rate at two flops per FMA). Integer work uses
# both the INT32 pipe and the FMA pipe (nvcc emits IMAD forms of adds and
# moves), so the INT32 pipe alone (64 lanes per SM) is not a ceiling. The
# conv routes run ``conv1d`` in float32, which cuDNN may compute in TF32 on
# the tensor cores under PyTorch's default
# ``torch.backends.cudnn.allow_tf32 = True``: 495 TFLOP/s dense, the most
# the card gives this work. (On an H100 cuDNN ran the k = 0 conv of two
# planes as a direct float32 kernel, ``conv2d_grouped_direct_kernel``, off
# the tensor cores: ``mfu_tc`` is then the share of the card's best rate
# for the conv's FLOPs, not of the unit that ran it. ``chip_smoke.py``
# phase 14 prints the kernel.)
PEAK_HBM = 3.35e12  # bytes/s
PEAK_INT_ISSUE = 132 * 128 * 1.98e9  # instructions/s
PEAK_TC_TF32 = 495e12  # FLOP/s

# Instructions per unit of work, counted from the work whatever implements
# it, at the fewest instructions the card needs. The work of an exact scan
# is the early-exit byte compares it needs (bytes compared up to the first
# mismatch), 3 each (load, compare, branch). Kernels B, #8 and #7 compare
# each pattern or piece at every position they own; kernel D compares each
# piece's head bytes (its first min(li, 8) bytes, or min(8, li // 2) in the
# banded tier) at every text position an owned window reaches (lanes
# [0, limit + span) from o + s_lo), which any exact or banded piece test
# must do at least. Steps of one design (a shift OR per window and shift,
# the band on the survivors) are not counted: a bound that counted them
# would credit a kernel that skips them with work it does not do.
COMPARE_OPS = 3
# The banded DP (kernels A, C, #4, #6 and #9, count and mask alike): a band
# cell is a compare and three min-plus terms, four instructions for the two
# windows of a paired 16-bit word on Hopper's DPX forms (XOR, VIADDMNMX,
# VIMNMX3, VIADDMNMX), so 2 a window; a window costs m_p steps of
# 2 min(k, m_max) + 1 cells per pattern. A Myers step is Hyyro's bit-vector
# update with each logic term of up to three inputs one LOP3: eq & vp, the
# add, xh and xv (4), ph (2), mh (1), ph's and mh's shifts with their masks
# (4), the centre bit and the count (3), vp (2) and vn (1), 17 in all, plus
# the match word's load; the moving band re-indexes VP and VN first (3
# more). Where the band fits a 16-bit field (2k + 1 <= 15) one update
# advances two windows packed in one word, for two match-word loads and one
# instruction that joins the two words: 20 a pair (23 moving), 10 and 11.5
# a window.
BAND_CELL_INSTR = 2
MYERS_STATIC_STEP_INSTR = 18
MYERS_MOVING_STEP_INSTR = 21
MYERS_PAIR_STATIC_STEP_INSTR = 20
MYERS_PAIR_MOVING_STEP_INSTR = 23


def band_instr(owned: int, plens, k: int) -> int:
    """Least instructions of the band over ``owned`` windows: m_p steps of
    2 min(k, m_p) + 1 cells per pattern (wider diagonals never reach
    D[m_p][m_p])."""
    return owned * sum(m * (2 * min(k, m) + 1) for m in plens) * BAND_CELL_INSTR


def _myers_pair_instr(plens, k: int) -> int:
    """Instructions of one packed update chain over a window pair."""
    return sum(min(k, m) * MYERS_PAIR_STATIC_STEP_INSTR
               + max(m - k, 0) * MYERS_PAIR_MOVING_STEP_INSTR for m in plens if m)


def myers_instr(owned: int, plens, k: int) -> int:
    """Least instructions of the Myers band over ``owned`` windows: min(k, m)
    static steps and m - k moving steps per pattern, a window pair per
    update where 2k + 1 <= 15, else one window."""
    if 2 * k + 1 <= 15:
        return owned * _myers_pair_instr(plens, k) // 2
    return owned * sum(min(k, m) * MYERS_STATIC_STEP_INSTR
                       + max(m - k, 0) * MYERS_MOVING_STEP_INSTR for m in plens if m)


def compare_ops(rows, seqs, limits, wf, width=None) -> int:
    """Integer operations of early-exit byte compares over the owned
    windows of staged rows (the data decides where each exits): for each
    ``(bytes, offset)`` in ``seqs``, a window at lane ``l`` compares
    ``bytes`` with the text at ``l + offset`` until the first mismatch.
    ``limits[r]`` lanes of row ``r`` are scanned, of ``width`` (default
    ``wf``) positions per row."""
    import torch

    dev = rows.device
    width = width or wf
    lane = torch.arange(width, device=dev)
    own = lane[None, :] < torch.as_tensor(np.asarray(limits), device=dev)[:, None]
    total = 0
    for seq, off in seqs:
        alive = own.clone()
        for i, b in enumerate(seq):
            n = int(alive.sum())
            if n == 0:
                break
            total += n
            alive &= rows[:, off + i : off + i + width] == int(b)
    return total * COMPARE_OPS


def filter_ops(rows, raw, plens, k, limits, wf) -> int:
    """Integer operations of kernel D's work on these inputs (the rule
    above): each piece's head bytes compared, up to the first mismatch, at
    every position an owned window of its row reaches."""
    from ..ops.filter_kernel import piece_layout

    table, pstart = piece_layout(tuple(int(m) for m in plens), k)
    total = 0
    for p in range(len(plens)):
        for off, span, _li, _kp, o, _t, n_head, _n in table[pstart[p] : pstart[p + 1]].tolist():
            reach = np.where(limits > 0, limits + span, 0)
            total += compare_ops(rows, [(raw[p, o : o + n_head], off)], reach, wf, width=wf + span)
    return total


@dataclass(frozen=True)
class OpsModel:
    """Per-corpus-byte cost model of one scan's engines."""

    int_instr: float  # integer instructions per corpus byte
    tc_flops: float  # tensor-core (TF32) FLOPs per corpus byte
    hbm_bytes: float  # device-memory bytes per corpus byte
    binding: str  # the unit the model says binds first: "int", "tc" or "hbm"

    def mfu(self, bytes_per_s: float) -> Dict[str, float]:
        """Measured shares of each peak at a measured throughput."""
        out = {
            "mfu_int": self.int_instr * bytes_per_s / PEAK_INT_ISSUE,
            "mfu_tc": self.tc_flops * bytes_per_s / PEAK_TC_TF32,
            "hbm_frac": self.hbm_bytes * bytes_per_s / PEAK_HBM,
            "binding": self.binding,
        }
        out["roof_mb_per_s"] = self.roof_bytes_per_s() / 1e6
        return out

    def roof_bytes_per_s(self) -> float:
        """Throughput at which the first unit saturates."""
        roofs = []
        if self.int_instr > 0:
            roofs.append(PEAK_INT_ISSUE / self.int_instr)
        if self.tc_flops > 0:
            roofs.append(PEAK_TC_TF32 / self.tc_flops)
        if self.hbm_bytes > 0:
            roofs.append(PEAK_HBM / self.hbm_bytes)
        return min(roofs) if roofs else float("inf")


def _model(int_instr: float, tc_flops: float, hbm: float) -> OpsModel:
    t = {"int": int_instr / PEAK_INT_ISSUE, "tc": tc_flops / PEAK_TC_TF32, "hbm": hbm / PEAK_HBM}
    return OpsModel(int_instr, tc_flops, hbm, max(t, key=t.get))


def band_model(plens: Sequence[int], k: int) -> OpsModel:
    """Banded DP (kernels A, #4, #6, #9): :func:`band_instr` at one owned
    window, ``sum_p m_p (2 min(k, m_p) + 1)`` cells at
    :data:`BAND_CELL_INSTR`; the text read once."""
    return _model(float(band_instr(1, plens, k)), 0.0, 1.0)


def myers_model(plens: Sequence[int], k: int) -> OpsModel:
    """Bit-parallel band (kernel C): :func:`myers_instr` at one owned
    window, a window pair per update where 2k + 1 <= 15. A step costs the
    same at every band width: past the pair limit the count no longer
    grows with k (static steps are a little cheaper than moving ones)."""
    if 2 * k + 1 <= 15:
        instr = _myers_pair_instr(plens, k) / 2
    else:
        instr = float(myers_instr(1, plens, k))
    return _model(instr, 0.0, 1.0)


def fused_corr_model(n_seqs: int) -> OpsModel:
    """An exact scan (kernel B and its batch mode #8 over ``n_seqs``
    patterns, kernel #7 over ``n_seqs`` exact-tier pieces): the floor of
    one compare per pattern or piece and position, at
    :data:`COMPARE_OPS`; the text read once. On the card these kernels
    compare bytes; ``apm``'s are matrix products on the TPU's matrix
    unit, so its model puts this work in ``mfu_mxu`` where the port's
    puts it in ``mfu_int``."""
    return _model(float(n_seqs * COMPARE_OPS), 0.0, 1.0)


def corr_model(n_base: int, w_kern: int, alphabet_size: int) -> OpsModel:
    """A conv route: the k = 0 conv ``scan_corr_mxu`` (``n_base``
    patterns, ``w_kern = m_max``) or the piece conv ``scan_pieces_conv``
    (``n_base`` pieces, ``w_kern`` the longest piece), both
    ``ops/corr_engine.py``'s stride-1 ``conv1d`` of the base kernel:
    ``2 n_base w_kern B`` FLOPs per byte on the tensor cores, B the ±1
    planes (``n_bitplanes``). Integer side: one threshold compare per
    score (``n_base`` per byte) at :data:`COMPARE_OPS`. Memory: the text
    byte, and the B float32 planes of ``_encode_planes`` written once and
    read once by the conv (8 B bytes). The int64 byte index and the float32
    scores the port also moves are not counted: a floor, like the rest."""
    from ..ops.corr_engine import n_bitplanes

    b = n_bitplanes(alphabet_size)
    return _model(float(n_base * COMPARE_OPS), 2.0 * n_base * w_kern * b, 1.0 + 8.0 * b)


def filter_shiftor_model(plens: Sequence[int], k: int) -> OpsModel:
    """Pigeonhole phase 1 (kernel D, ``apm``'s shift-OR filter): the floor
    of :func:`filter_ops`, one head-byte compare per piece at every
    position (an owned window reaches at least one), over each pattern's
    pieces: ``k + 1`` in the exact tier, ``k // 2 + 1`` in the banded
    tier (``tier_of``)."""
    from ..ops.filter_kernel import tier_of

    pieces = sum(tier_of(m, k)[0] for m in plens if m > 0)
    return _model(float(pieces * COMPARE_OPS), 0.0, 1.0)


def model_for_scanner(scanner, n: int) -> Optional[OpsModel]:
    """Ops model of the routes a Scanner takes for an ``n``-byte ``count``
    (``make_plan`` and its ``routes``), summed over its engines:
    the k = 0 correlation set (kernel B or the conv), filtration phase 1
    (kernel D at k = 0 or without a conv phase 1; else kernel #7 where the
    routes chose it, or the piece conv) and the banded DP (kernel C in
    Myers mode, else A). Memory is the most any engine moves per byte (they
    read the same staged text). Returns None only where the scan has no
    device path (no window is device-owned: the host counts them all). A
    plan or route that cannot be made raises, as the scan would.

    Where ``apm``'s differs: its fused-piece model is gated on the k = 0
    count gate (``apm/utils/roofline.py:209``), so it raises for k >= 1 at
    65 < m_max <= 97; here it follows the route the scan takes
    (``fused_pieces_ok``). It divides the fused tables' columns by
    ``S_FUSED`` (``:200``, ``:213``); here patterns and pieces are
    counted directly."""
    from ..models.pipeline import make_plan
    from ..ops.filter_kernel import pieces_of_j, tier_of

    plan = make_plan(scanner, n)
    if plan.dev_bound <= 0:
        return None
    corr, fp1 = plan.routes.corr, plan.routes.fp1
    c = len(scanner._corr_alphabet())
    k = scanner.k
    parts = []
    if corr:
        n_live = sum(1 for m in plan.plens_corr if m > 0)
        parts.append(fused_corr_model(n_live) if corr == "fused"
                     else corr_model(n_live, scanner.m_max, c))
    if plan.any_filter:
        if fp1 is None:
            parts.append(filter_shiftor_model(plan.plens_filter, k))
        else:
            pieces = [length for m in plan.plens_filter if m > 0
                      for _, length in pieces_of_j(m, tier_of(m, k)[0])]
            parts.append(fused_corr_model(len(pieces)) if fp1 == "fused"
                         else corr_model(len(pieces), max(pieces), c))
    if plan.any_dp:
        parts.append(myers_model(plan.plens_dp, k) if plan.routes.dp_mode == "myers"
                     else band_model(plan.plens_dp, k))
    int_instr = sum(p.int_instr for p in parts)
    tc = sum(p.tc_flops for p in parts)
    if int_instr == 0.0 and tc == 0.0:
        return None
    return _model(int_instr, tc, max(p.hbm_bytes for p in parts))


def mfu_fields(scanner, n: int, bytes_per_s: float) -> Dict[str, float]:
    """Rounded shares for a record, rounded as ``apm`` rounds them
    (empty when there is no model or no throughput): ``mfu_int``,
    ``mfu_tc``, ``hbm_frac``, ``binding`` and ``roof_mb_per_s``."""
    m = model_for_scanner(scanner, n)
    if m is None or bytes_per_s <= 0:
        return {}
    f = m.mfu(bytes_per_s)
    return {
        "mfu_int": round(f["mfu_int"], 4),
        "mfu_tc": round(f["mfu_tc"], 4),
        "hbm_frac": round(f["hbm_frac"], 4),
        "binding": f["binding"],
        "roof_mb_per_s": round(f["roof_mb_per_s"], 1),
    }
