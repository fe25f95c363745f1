"""Exact-match (k = 0) window count: kernel B and its plain PyTorch version.

Port of ``apm/ops/corr_fused.py::scan_corr_fused`` (kernel
``_fused_kernel``) and of the code that builds its tables. Contract of the
scan, shared by both functions here: staged rows ``(R, wf + halo)`` uint8,
the global window ``bound`` (exclusive) and ``start``, and ``n_rows``; row
``r < n_rows`` owns lanes
``[0, clip(bound - start - r*wf, 0, wf))`` and an owned window counts for
slot ``p`` iff it matches pattern ``p`` exactly. Returns
``(max(p, p_out),)`` int32 counts.

The "weights" are ``apm``'s phase-folded ±1 tables (:func:`build_fused_tables`):
``km[b*128 + i', s*p + q]`` is ±1 for code bit ``b`` of pattern ``q``'s byte
``i' - s`` (0 elsewhere), ``thr[0, s*p + q] = B * m_q`` (``2**30`` for
padding slots), with ``s_ph = pick_s(m_max)`` phase offsets. The plain
version (:func:`scan_corr_fused_ref`) runs that TPU formulation itself:
±1 bit-plane encode, a float32 matmul against ``km``, threshold, per-row
ownership, phase fold. The CUDA kernel (``csrc/corr_fused.cu``) compares
bytes instead, from the pattern bytes :func:`decode_fused_tables` recovers
from the same tables and their 8-byte prefix words (:func:`prefix_words`);
the two compute the count two different ways.

Batch mode (:func:`scan_corr_batch_fused`, ``apm``'s
``scan_corr_batch_fused``, TPU kernel #8; ``Scanner.count_batch`` at
k = 0): rows of many corpora, each row's ownership given as its owned
lanes ``limits[r]`` (the caller resolves every corpus's bound), counts per
block of ``fold`` rows, ``(R/fold, max(p, p_out))`` int32.

Piece scan (:func:`scan_pieces_fused`, ``apm``'s ``scan_pieces_fused``,
TPU kernel #7; filtration phase 1 under ``corr_impl="fused"`` at k >= 1):
the exact-tier pieces of every pattern in ``apm``'s phase-folded piece
tables (:func:`build_fused_piece_tables`). A staged row ``r`` is live iff
``r < n_rows`` and ``start + r*wf < bound``; in a live row every piece is
tested at every position ``j < wf + 64`` (``apm``'s coverage bound, not the
ownership limit). Returns ``fcnt (P,)``, the hits summed over rows, and
``rowmap (R, P)``, 1 where a row holds a hit of the pattern, both int32.
The CUDA kernel (``csrc/corr_pieces.cu``) compares the piece bytes that
:func:`decode_fused_piece_tables` recovers from the tables, prefix words
first; the plain version (:func:`scan_pieces_fused_ref`) compares shifted
slices of the rows.

Kernels B (both modes) and #7 read the staged rows with 16-byte vector
loads: on the card
the rows' pointer and row stride must be multiples of 16 bytes
(:func:`check_aligned_rows`); a view at a row offset of staged rows
(``rows[3:]``) is, since ``wf + halo`` is a multiple of 128.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .corr_engine import _encode_planes, n_bitplanes

# Kernel launches made by scan_corr_fused, scan_corr_batch_fused and
# scan_pieces_fused.
LAUNCHES = 0
BATCH_LAUNCHES = 0
PIECE_LAUNCHES = 0

S_FUSED = 64
M_MAX_FUSED = 97  # m + 32 - 1 <= 128: one 128-byte K-tile per phase
M_MAX_PIECES = 65  # the fused piece scan's coverage proof (kernel #7)
_PIECE_REACH = 64  # piece positions past wf that kernel #7 covers
_SINGLE_MAX = 1536  # apm's column-chunking threshold (pads P when above)
_INT8_MIN_SLOTS = 32  # apm's int8-operand threshold
_SENTINEL = 2**30  # threshold of padding slots: never reached

# Slots per launch. A block holds the group in shared memory, within the
# 227 KB a block may take: kernel B's count mode 24 bytes a slot (prefix
# word and mask, length, counter: 192 KB), its batch mode (#8) 20 (prefix
# word and mask, length); kernel #7 12 bytes a pattern (_PIECE_GROUP).
_PAT_GROUP = 8192
# Kernels B (both modes) and #7 (csrc/exact_scan.cuh): a block covers at
# most 288 threads x 32 windows of a row per grid-stride item, and their
# __launch_bounds__ fit 2 blocks on an SM.
_EXACT_SEG = 288 * 32
_EXACT_BLOCKS_PER_SM = 2
# Staged rows per matmul group of the plain version (bounds its memory).
_REF_GROUP_BYTES = 256 << 20


def pick_s(m_max: int) -> int:
    """Phase stride of the tables: the widest S with m + S - 1 <= 128
    among {64, 32}."""
    return 64 if m_max <= 65 else 32


def fused_eligible(m_max: int) -> bool:
    """``apm``'s gate of the fused count kernel: m <= 97. Its staging
    checks (lane-tiled rows, a >= 128-byte halo) hold for every plan
    (:func:`apm_torch.models.pipeline.staging`)."""
    return 0 < m_max <= M_MAX_FUSED


def fused_pieces_ok(m_max: int) -> bool:
    """``apm``'s gate of its fused piece scan (:func:`scan_pieces_fused`),
    which ``corr_impl="fused"`` selects for conv phase 1: the count gate and
    m_max <= 65, which the piece coverage bound ``wf + 64`` needs."""
    return fused_eligible(m_max) and m_max <= M_MAX_PIECES


def build_fused_tables(pat_raw: np.ndarray, plens, alphabet: np.ndarray):
    """±1 phase-folded tables ``(km (B*128, s_ph*p), thr (1, s_ph*p))``.

    NumPy port of ``apm``'s function of the same name: ``km`` is float32
    (``apm`` casts it to bf16; ±1/0 are exact in both) with float32 thresholds, or int8 with
    int32 thresholds from ``_INT8_MIN_SLOTS`` slots up, as in ``apm``.
    """
    P, m_max = pat_raw.shape
    if m_max > M_MAX_FUSED:
        raise ValueError(f"m_max {m_max} > {M_MAX_FUSED}")
    s_ph = pick_s(m_max)
    B = n_bitplanes(len(alphabet))
    align = 128 // s_ph
    p_pad = P
    if s_ph * P > _SINGLE_MAX and P % align:
        p_pad = P + align - P % align
    km = np.zeros((B, 128, s_ph * p_pad), dtype=np.float32)
    thr = np.full((1, s_ph * p_pad), np.float32(_SENTINEL), dtype=np.float32)
    for pi in range(P):
        m = plens[pi]
        for s in range(s_ph):
            col = s * p_pad + pi
            thr[0, col] = B * m if m > 0 else np.float32(_SENTINEL)
            for i in range(min(m, m_max)):
                ci = int(np.searchsorted(alphabet, pat_raw[pi, i]))
                for b in range(B):
                    km[b, s + i, col] = 1.0 if (ci >> b) & 1 else -1.0
    km2 = km.reshape(B * 128, s_ph * p_pad)
    if p_pad >= _INT8_MIN_SLOTS:
        return km2.astype(np.int8), thr.astype(np.int32)
    return km2, thr


def decode_fused_tables(
    km: np.ndarray, thr: np.ndarray, alphabet: np.ndarray, s_ph: int
):
    """Pattern bytes and lengths held by the tables: ``(pat (p, m) uint8,
    plen (p,) int32)``, ``plen = 0`` for sentinel slots.

    Phase slot ``s = 0`` of slot ``q`` holds the code bits of pattern byte
    ``i`` at rows ``b*128 + i``; the code is the byte's rank in the sorted
    alphabet, and every other phase ``s`` repeats that column ``s`` rows
    down. Raises if the tables are not of that form.
    """
    km = np.asarray(km, dtype=np.float32)
    thr = np.asarray(thr, dtype=np.float64).reshape(-1)
    alphabet = np.asarray(alphabet, dtype=np.uint8)
    B = n_bitplanes(len(alphabet))
    if km.shape[0] != B * 128 or km.shape[1] != thr.shape[0]:
        raise ValueError(f"km {km.shape} / thr {thr.shape} / B {B} disagree")
    if s_ph not in (32, 64) or km.shape[1] % s_ph:
        raise ValueError(f"{km.shape[1]} columns do not split into s_ph {s_ph}")
    p = km.shape[1] // s_ph
    planes = km.reshape(B, 128, s_ph, p)
    for s in range(1, s_ph):
        shifted = np.zeros_like(planes[:, :, 0])
        shifted[:, s:] = planes[:, : 128 - s, 0]
        if not np.array_equal(planes[:, :, s], shifted) or not np.array_equal(
            thr[s * p : (s + 1) * p], thr[:p]
        ):
            raise ValueError(f"phase {s} is not phase 0 shifted by {s}")
    lens = np.where(thr[:p] < _SENTINEL, thr[:p] / B, 0)
    if np.any(lens != np.round(lens)) or np.any(lens > 128 - s_ph + 1):
        raise ValueError("thresholds are not B * m with m + s_ph - 1 <= 128")
    plen = lens.astype(np.int32)
    m_max = int(plen.max()) if p else 0
    planes = planes[:, :, 0]  # (B, 128, p)
    pat = np.zeros((p, max(m_max, 1)), dtype=np.uint8)
    weights = (1 << np.arange(B)).reshape(B, 1)
    for q in range(p):
        m = int(plen[q])
        if m == 0:
            continue
        col = planes[:, :m, q]  # (B, m) of ±1
        if np.any(col == 0):
            raise ValueError(f"slot {q}: zero code bit inside the pattern")
        codes = ((col > 0) * weights).sum(axis=0)
        if np.any(codes >= len(alphabet)):
            raise ValueError(f"slot {q}: code outside the alphabet")
        pat[q, :m] = alphabet[codes]
    return pat, plen


def prefix_words(pat: np.ndarray, plen) -> np.ndarray:
    """``(P, 2)`` uint64: each slot's 8-byte prefix word and its mask, as
    kernels B and #7 test them.

    The word packs the slot's first ``min(m, 8)`` bytes little-endian (byte
    ``i`` in bits ``8i .. 8i + 7``), the mask holds 0xff in those bytes and
    0 above them; a sentinel slot (``m = 0``) has word and mask 0. In
    memory a row is four little-endian uint32: word lo, word hi, mask lo,
    mask hi.
    """
    pat = np.asarray(pat, dtype=np.uint8).reshape(len(plen), -1)
    n = np.minimum(np.asarray(plen, dtype=np.int64), 8)
    keep = np.arange(8)[None, :] < n[:, None]  # (P, 8)
    head = np.zeros((len(n), 8), dtype=np.uint8)
    w = min(8, pat.shape[1])
    head[:, :w] = pat[:, :w]
    out = np.empty((len(n), 2), dtype=np.uint64)
    out[:, 0] = np.where(keep, head, 0).astype(np.uint8).view("<u8")[:, 0]
    out[:, 1] = np.where(keep, 0xFF, 0).astype(np.uint8).view("<u8")[:, 0]
    return out


def _prefix_tensor(pat, plen, dev) -> torch.Tensor:
    """:func:`prefix_words` as a ``(P, 2)`` int64 tensor (the same bits)."""
    return torch.from_numpy(prefix_words(pat, plen).view(np.int64)).to(dev)


def check_aligned_rows(rows: torch.Tensor, align: int = 16) -> None:
    """Raise unless a kernel can read ``rows`` with ``align``-byte loads:
    unit column stride, and the data pointer and the row stride multiples
    of ``align`` bytes. Kernels B (both modes) and #7 read 16-byte vectors,
    kernel D copies 4-byte words. No copy is made in their stead."""
    if rows.stride(1) != 1 or rows.data_ptr() % align or rows.stride(0) % align:
        raise ValueError(
            f"rows at {rows.data_ptr():#x} with strides {tuple(rows.stride())}: the kernel "
            f"needs unit column stride and a {align}-byte aligned pointer and row stride"
        )


@dataclass(frozen=True)
class FusedTables:
    """The fused tables on one device, with the pattern bytes and prefix
    words kernel B reads (decoded from ``km``/``thr``/``alph`` once)."""

    km: torch.Tensor  # (B*128, s_ph*p) float32 or int8
    thr: torch.Tensor  # (1, s_ph*p) float32 or int32
    alph: torch.Tensor  # (C,) uint8, sorted pattern alphabet
    pat: torch.Tensor  # (p, m) uint8 decoded pattern bytes
    plen: torch.Tensor  # (p,) int32 decoded lengths, 0 = sentinel slot
    prefix: torch.Tensor  # (p, 2) int64 prefix words and masks (prefix_words)
    s_ph: int
    b_planes: int

    @property
    def p(self) -> int:
        return int(self.plen.shape[0])

    @staticmethod
    def from_numpy(km, thr, alph, s_ph: int, device) -> "FusedTables":
        km = np.asarray(km)
        if km.dtype not in (np.float32, np.int8):
            km = km.astype(np.float32)
        pat, plen = decode_fused_tables(km, thr, alph, s_ph)
        dev = torch.device(device)
        return FusedTables(
            km=torch.from_numpy(np.ascontiguousarray(km)).to(dev),
            thr=torch.from_numpy(np.ascontiguousarray(thr)).to(dev),
            alph=torch.from_numpy(np.asarray(alph, dtype=np.uint8).copy()).to(dev),
            pat=torch.from_numpy(pat).to(dev),
            plen=torch.from_numpy(plen).to(dev),
            prefix=_prefix_tensor(pat, plen, dev),
            s_ph=s_ph,
            b_planes=n_bitplanes(len(alph)),
        )


def _check_rows(rows, wf, halo, n_rows, tables) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be 2-D uint8, got {rows.dtype} {tuple(rows.shape)}")
    if rows.shape[1] != wf + halo or rows.shape[0] <= 0:
        raise ValueError(f"rows shape {tuple(rows.shape)} != (R, wf + halo = {wf + halo})")
    if not (wf % 128 == 0 and halo % 128 == 0 and halo >= 128):
        raise ValueError(f"wf {wf} / halo {halo}: need 128-aligned rows, halo >= 128")
    if tables.pat.shape[1] > M_MAX_FUSED:
        raise ValueError(f"patterns longer than {M_MAX_FUSED}")
    if n_rows < 0:
        raise ValueError(f"n_rows {n_rows} < 0")
    if tables.km.device != rows.device:
        raise ValueError(f"rows on {rows.device}, tables on {tables.km.device}")


def scan_corr_fused(
    rows: torch.Tensor,
    tables: FusedTables,
    bound: int,
    start: int,
    *,
    wf: int,
    halo: int,
    n_rows: int,
    p_out: int = 0,
) -> torch.Tensor:
    """(max(p, p_out),) int32 exact-match counts of this chunk (module
    contract). CUDA tensors go to the kernel (current stream, no
    synchronisation); CPU tensors to :func:`scan_corr_fused_ref`."""
    _check_rows(rows, wf, halo, n_rows, tables)
    if rows.device.type == "cpu":
        return scan_corr_fused_ref(
            rows, tables, bound, start, wf=wf, halo=halo, n_rows=n_rows,
            p_out=p_out,
        )
    if rows.device.type != "cuda":
        raise ValueError(f"no correlation kernel for device {rows.device}")
    return _launch(rows, tables, int(bound), int(start), wf, n_rows, p_out)


def _grid(dev, n_items: int, per_sm: int) -> int:
    """Blocks of a grid-stride launch: ``per_sm`` on every SM, at most one
    per item."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(n_items, sms * per_sm))


def batch_grid(dev, n_staged: int, wf: int) -> int:
    """Blocks of a kernel #8 launch over ``n_staged`` rows of ``wf``
    windows (as kernel B's count mode)."""
    return _grid(dev, n_staged * -(-wf // _EXACT_SEG), _EXACT_BLOCKS_PER_SM)


def batch_threads(wf: int) -> int:
    """Threads of a kernel #8 block over rows of ``wf`` windows: whole
    warps of 32-window tiles, at most 288 (``exact_scan.cuh``'s
    ``threads_for``)."""
    return min(_EXACT_SEG // 32, -(-wf // (32 * 32)) * 32)


def _launch(rows, tables, bound, start, wf, n_rows, p_out) -> torch.Tensor:
    global LAUNCHES
    from ._build import check, library

    check_aligned_rows(rows)
    lib = library()
    dev = rows.device
    p = tables.p
    out = torch.zeros((max(p, p_out),), dtype=torch.int32, device=dev)
    if min(n_rows, rows.shape[0]) == 0:
        return out
    grid = _grid(dev, min(n_rows, rows.shape[0]) * -(-wf // _EXACT_SEG), _EXACT_BLOCKS_PER_SM)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pat, plen, prefix = tables.pat, tables.plen, tables.prefix
    for g0 in range(0, p, _PAT_GROUP):
        ng = min(_PAT_GROUP, p - g0)
        err = lib.apm_corr_fused_count(
            rows.data_ptr(), rows.shape[0], rows.stride(0), n_rows,
            pat[g0].data_ptr(), ng, pat.shape[1], plen[g0].data_ptr(),
            prefix[g0].data_ptr(), wf, bound, start, out[g0].data_ptr(), grid, stream,
        )
        check(err, "apm_corr_fused_count")
        LAUNCHES += 1
    return out


def _check_limits(rows, limits, fold) -> None:
    if fold <= 0 or rows.shape[0] % fold:
        raise ValueError(f"batch rows {rows.shape[0]} are not a multiple of fold {fold}")
    if (
        not isinstance(limits, torch.Tensor) or tuple(limits.shape) != (rows.shape[0],)
        or limits.dtype != torch.int32 or limits.device != rows.device
    ):
        raise ValueError(f"limits must be int32 ({rows.shape[0]},) on {rows.device}")


def scan_corr_batch_fused(
    rows: torch.Tensor,
    tables: FusedTables,
    limits: torch.Tensor,
    *,
    wf: int,
    halo: int,
    fold: int = 8,
    p_out: int = 0,
    plain: bool = False,
) -> torch.Tensor:
    """(R/fold, max(p, p_out)) int32 per-block exact-match counts of a batch
    (module doc, batch mode). CUDA tensors go to the kernel's batch mode
    (current stream, no synchronisation; 16-byte aligned rows,
    :func:`check_aligned_rows`); CPU tensors, and any tensor under
    ``plain=True``, to :func:`scan_corr_batch_fused_ref`."""
    _check_rows(rows, wf, halo, rows.shape[0], tables)
    _check_limits(rows, limits, fold)
    if plain or rows.device.type == "cpu":
        return scan_corr_batch_fused_ref(
            rows, tables, limits, wf=wf, halo=halo, fold=fold, p_out=p_out
        )
    if rows.device.type != "cuda":
        raise ValueError(f"no correlation kernel for device {rows.device}")
    global BATCH_LAUNCHES
    from ._build import check, library

    check_aligned_rows(rows)
    lib = library()
    dev = rows.device
    p = tables.p
    width = max(p, p_out)
    out = torch.zeros((rows.shape[0] // fold, width), dtype=torch.int32, device=dev)
    grid = batch_grid(dev, rows.shape[0], wf)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pat, plen, prefix = tables.pat, tables.plen, tables.prefix
    for g0 in range(0, p, _PAT_GROUP):
        ng = min(_PAT_GROUP, p - g0)
        err = lib.apm_corr_batch_count(
            rows.data_ptr(), rows.shape[0], rows.stride(0),
            pat[g0].data_ptr(), ng, pat.shape[1], plen[g0].data_ptr(),
            prefix[g0].data_ptr(), wf, limits.data_ptr(), fold,
            out.data_ptr() + 4 * g0, width, grid, stream,
        )
        check(err, "apm_corr_batch_count")
        BATCH_LAUNCHES += 1
    return out


def _corr_row_counts(rows, tables, limit, wf) -> torch.Tensor:
    """``(R, p)`` int64 exact-match counts per staged row and slot, row
    ``r`` owning lanes ``[0, limit[r])``, by the TPU formulation.

    Windows come in phase blocks of ``s_ph``: the block at ``base`` (a
    multiple of ``s_ph``) reads the 128 text bytes ``[base, base + 128)``,
    encoded into B ±1 planes, and one matmul against ``km`` scores all
    ``s_ph * p`` (offset, pattern) columns; window ``base + s`` matches
    pattern ``q`` iff column ``s*p + q`` reaches ``thr``. The phase offsets
    fold back per pattern (``apm``'s ``batch_owner`` product, as a sum).
    Exactness: both matmul operands are in {-1, 0, 1} and every partial
    sum is an integer of magnitude <= B * 128 < 2**24, so the float32
    matmul is exact under any float32 matmul precision (TF32 or bf16
    inputs represent ±1 exactly, accumulation is float32).
    """
    dev = rows.device
    s_ph, B, p = tables.s_ph, tables.b_planes, tables.p
    km = tables.km.to(torch.float32)  # (B*128, s_ph*p)
    thr = tables.thr.to(torch.float32).reshape(1, 1, -1)
    nb = wf // s_ph  # phase blocks per row that hold owned windows
    # Window offset of each column: s for column s*p + q.
    s_col = torch.arange(s_ph * p, device=dev) // p
    base = torch.arange(nb, device=dev) * s_ph  # (nb,)
    j = base[None, :, None] + s_col[None, None, :]  # (1, nb, s_ph*p)
    per_row = nb * max(B * 128, s_ph * p) * 4
    g = max(1, _REF_GROUP_BYTES // per_row)
    counts = []
    for r0 in range(0, rows.shape[0], g):
        rg = rows[r0 : r0 + g]
        planes = _encode_planes(rg, tables.alph, B)  # (g, B, L)
        # im2col: (g, B, nb, 128) -> (g*nb, B*128), plane-major like km.
        lhs = planes.unfold(2, 128, s_ph)[:, :, :nb]
        lhs = lhs.permute(0, 2, 1, 3).reshape(-1, B * 128)
        corr = (lhs @ km).reshape(rg.shape[0], nb, -1)  # (g, nb, s_ph*p)
        lim = limit[r0 : r0 + g].to(torch.int64)
        match = (corr >= thr) & (j < lim[:, None, None])
        counts.append(match.sum(dim=1).reshape(-1, s_ph, p).sum(dim=1))
    return torch.cat(counts)


def scan_corr_fused_ref(
    rows: torch.Tensor,
    tables: FusedTables,
    bound: int,
    start: int,
    *,
    wf: int,
    halo: int,
    n_rows: int,
    p_out: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B: the TPU formulation
    (:func:`_corr_row_counts`), summed over the live rows."""
    _check_rows(rows, wf, halo, n_rows, tables)
    dev = rows.device
    p = tables.p
    out = torch.zeros((max(p, p_out),), dtype=torch.int32, device=dev)
    live_rows = min(n_rows, rows.shape[0])
    if live_rows == 0:
        return out
    r = torch.arange(live_rows, device=dev, dtype=torch.int64)
    limit = (bound - start - r * wf).clamp(0, wf)
    out[:p] = _corr_row_counts(rows[:live_rows], tables, limit, wf).sum(dim=0).to(torch.int32)
    return out


def scan_corr_batch_fused_ref(
    rows: torch.Tensor,
    tables: FusedTables,
    limits: torch.Tensor,
    *,
    wf: int,
    halo: int,
    fold: int = 8,
    p_out: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the batch mode: :func:`_corr_row_counts`
    under the given row limits, summed per block of ``fold`` rows."""
    _check_rows(rows, wf, halo, rows.shape[0], tables)
    _check_limits(rows, limits, fold)
    p = tables.p
    out = torch.zeros((rows.shape[0] // fold, max(p, p_out)), dtype=torch.int32, device=rows.device)
    per_row = _corr_row_counts(rows, tables, limits.clamp(0, wf), wf)
    out[:, :p] = per_row.reshape(-1, fold, p).sum(dim=1).to(torch.int32)
    return out


# -- kernel #7: the fused piece scan ------------------------------------------

# Piece slots per launch of kernel #7: its shared memory holds 24 bytes a
# piece (prefix word and mask, length, owner) and 12 a pattern (the block's
# total and a row's count in two halves) for the group's <= _PAT_GROUP
# patterns: 120 KB at most, within the 227 KB a block may take.
_PIECE_GROUP = 1024


def build_fused_piece_tables(pat_raw: np.ndarray, plens, k: int, alphabet: np.ndarray):
    """±1 phase-folded piece tables ``(km (B*128, 64*Np), thr (1, 64*Np),
    owner64 (64*Np, P))``: NumPy port of ``apm``'s function of the same
    name, ``km`` float32 (``apm`` casts it to bf16; ±1/0 are exact in both)
    with float32 thresholds, or int8 with int32 thresholds from
    ``_INT8_MIN_SLOTS`` slots up, as in ``apm``.

    The pieces are the exact-tier pieces of every pattern in pattern order;
    ``Np`` is their count, padded by one sentinel slot to an even count when
    ``64 * Np > _SINGLE_MAX`` (``apm``'s column chunking). Slot ``n`` of
    phase ``s`` (column ``s*Np + n``) holds the code bits of piece byte
    ``i`` at rows ``b*128 + s + i``, its threshold ``B * length``
    (``2**30`` for the sentinel) and its pattern's one-hot owner row.
    """
    from .filter_kernel import pieces_of_j, tier_of

    P, _ = pat_raw.shape
    if max(plens) > M_MAX_PIECES:
        raise ValueError(f"patterns longer than {M_MAX_PIECES}: {max(plens)}")
    B = n_bitplanes(len(alphabet))
    pieces = []  # (pattern index, offset, length)
    for pi in range(P):
        m = plens[pi]
        if m == 0:
            continue
        j, kp = tier_of(m, k)
        if kp != 0:
            raise ValueError("fused phase 1 is exact-tier only")
        pieces.extend((pi, off, length) for off, length in pieces_of_j(m, j))
    n = len(pieces)
    n_pad = n + (n % 2 if S_FUSED * n > _SINGLE_MAX else 0)
    km = np.zeros((B, 128, S_FUSED * n_pad), dtype=np.float32)
    thr = np.full((1, S_FUSED * n_pad), np.float32(_SENTINEL), dtype=np.float32)
    owner64 = np.zeros((S_FUSED * n_pad, P), dtype=np.float32)
    for ni, (pi, off, length) in enumerate(pieces):
        codes = np.searchsorted(alphabet, pat_raw[pi, off : off + length])
        bits = np.where((codes[None, :] >> np.arange(B)[:, None]) & 1, 1.0, -1.0)
        for s in range(S_FUSED):
            col = s * n_pad + ni
            thr[0, col] = B * length
            owner64[col, pi] = 1.0
            km[:, s : s + length, col] = bits
    km2 = km.reshape(B * 128, S_FUSED * n_pad)
    if n_pad >= _INT8_MIN_SLOTS:
        return km2.astype(np.int8), thr.astype(np.int32), owner64
    return km2, thr, owner64


def decode_fused_piece_tables(km: np.ndarray, thr: np.ndarray, owner64: np.ndarray,
                              alphabet: np.ndarray):
    """Pieces held by the piece tables: ``(piece (Np, l_max) uint8, plen
    (Np,) int32, owner (Np,) int32)``, ``plen = 0`` and ``owner = -1`` for
    sentinel slots.

    Phase ``s = 0`` of slot ``n`` holds the code bits of piece byte ``i`` at
    rows ``b*128 + i`` (the code is the byte's rank in the sorted alphabet);
    every other phase ``s`` repeats that column ``s`` rows down, with the
    same threshold and owner row. Raises if the tables are not of that form.
    """
    km = np.asarray(km, dtype=np.float32)
    thr = np.asarray(thr, dtype=np.float64).reshape(-1)
    owner64 = np.asarray(owner64, dtype=np.float32)
    alphabet = np.asarray(alphabet, dtype=np.uint8)
    B = n_bitplanes(len(alphabet))
    cols = km.shape[1]
    if km.shape[0] != B * 128 or thr.shape[0] != cols or owner64.ndim != 2 or owner64.shape[0] != cols:
        raise ValueError(f"km {km.shape} / thr {thr.shape} / owner64 {owner64.shape} / B {B} disagree")
    if cols % S_FUSED:
        raise ValueError(f"{cols} columns do not split into {S_FUSED} phases")
    n = cols // S_FUSED
    planes = km.reshape(B, 128, S_FUSED, n)
    thr2 = thr.reshape(S_FUSED, n)
    own = owner64.reshape(S_FUSED, n, owner64.shape[1])
    for s in range(1, S_FUSED):
        shifted = np.zeros_like(planes[:, :, 0])
        shifted[:, s:] = planes[:, : 128 - s, 0]
        if not (np.array_equal(planes[:, :, s], shifted) and np.array_equal(thr2[s], thr2[0])
                and np.array_equal(own[s], own[0])):
            raise ValueError(f"phase {s} is not phase 0 shifted by {s}")
    lens = np.where(thr2[0] < _SENTINEL, thr2[0] / B, 0)
    if np.any(lens != np.round(lens)) or np.any(lens < 0) or np.any(lens > M_MAX_PIECES):
        raise ValueError(f"thresholds are not B * l with 0 < l <= {M_MAX_PIECES}")
    plen = lens.astype(np.int32)
    real = plen > 0
    o = own[0]
    if not np.all((o == 0) | (o == 1)) or np.any(o.sum(axis=1) != real):
        raise ValueError("owner64 rows are not one-hot for pieces and zero for sentinels")
    owner = np.where(real, o.argmax(axis=1), -1).astype(np.int32)
    piece = np.zeros((n, max(int(plen.max(initial=0)), 1)), dtype=np.uint8)
    weights = (1 << np.arange(B)).reshape(B, 1)
    for q in range(n):
        length = int(plen[q])
        col = planes[:, :, 0, q]  # (B, 128)
        if np.any(col[:, :length] == 0) or np.any(col[:, length:] != 0):
            raise ValueError(f"slot {q}: code bits do not span its length {length}")
        codes = ((col[:, :length] > 0) * weights).sum(axis=0)
        if np.any(codes >= len(alphabet)):
            raise ValueError(f"slot {q}: code outside the alphabet")
        piece[q, :length] = alphabet[codes]
    return piece, plen, owner


def _piece_groups(plen: np.ndarray, owner: np.ndarray) -> tuple:
    """Launch groups ``(q0, q1, p0, p1)`` of kernel #7: consecutive slot
    ranges of at most ``_PIECE_GROUP`` slots whose real pieces' owners lie
    in ``[p0, p1)``, ``p1 - p0 <= _PAT_GROUP``."""
    groups = []
    q0 = lo = hi = None
    for q in np.flatnonzero(plen > 0):
        o = int(owner[q])
        if q0 is not None and (q - q0 >= _PIECE_GROUP or max(hi, o) - min(lo, o) >= _PAT_GROUP):
            groups.append((q0, last + 1, lo, hi + 1))
            q0 = None
        if q0 is None:
            q0, lo, hi = int(q), o, o
        lo, hi, last = min(lo, o), max(hi, o), int(q)
    if q0 is not None:
        groups.append((q0, last + 1, lo, hi + 1))
    return tuple(groups)


@dataclass(frozen=True)
class PieceTables:
    """The piece tables on one device, as kernel #7 reads them (decoded from
    ``km``/``thr``/``owner64`` once, with the pieces' prefix words)."""

    piece: torch.Tensor  # (Np, l_max) uint8 piece bytes
    plen: torch.Tensor  # (Np,) int32 piece lengths, 0 = sentinel slot
    owner: torch.Tensor  # (Np,) int32 owning pattern, -1 = sentinel slot
    prefix: torch.Tensor  # (Np, 2) int64 prefix words and masks (prefix_words)
    n_pat: int  # pattern columns of owner64 (the outputs' P)
    groups: tuple  # (q0, q1, p0, p1) launch groups (_piece_groups)

    @staticmethod
    def from_numpy(km, thr, owner64, alph, device) -> "PieceTables":
        piece, plen, owner = decode_fused_piece_tables(km, thr, owner64, alph)
        dev = torch.device(device)
        return PieceTables(
            piece=torch.from_numpy(piece).to(dev),
            plen=torch.from_numpy(plen).to(dev),
            owner=torch.from_numpy(owner).to(dev),
            prefix=_prefix_tensor(piece, plen, dev),
            n_pat=int(np.asarray(owner64).shape[1]),
            groups=_piece_groups(plen, owner),
        )


def _check_piece_rows(rows, wf, halo, n_rows, tables) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be 2-D uint8, got {rows.dtype} {tuple(rows.shape)}")
    if rows.shape[1] != wf + halo or rows.shape[0] <= 0 or wf <= 0:
        raise ValueError(f"rows shape {tuple(rows.shape)} != (R, wf + halo = {wf + halo})")
    reach = _PIECE_REACH - 1 + tables.piece.shape[1]
    if halo < reach:
        raise ValueError(f"halo {halo} < {reach}: pieces at positions < wf + 64 read past the row")
    if n_rows < 0:
        raise ValueError(f"n_rows {n_rows} < 0")
    if tables.piece.device != rows.device:
        raise ValueError(f"rows on {rows.device}, piece tables on {tables.piece.device}")


def scan_pieces_fused(
    rows: torch.Tensor,
    tables: PieceTables,
    bound: int,
    start: int,
    *,
    wf: int,
    halo: int,
    n_rows: int,
    plain: bool = False,
):
    """``(fcnt (P,) int32, rowmap (R, P) int32)`` of this chunk's piece
    scan (module doc, piece scan). CUDA tensors go to kernel #7 (current
    stream, no synchronisation); CPU tensors, and any tensor under
    ``plain=True``, to :func:`scan_pieces_fused_ref`."""
    _check_piece_rows(rows, wf, halo, n_rows, tables)
    if plain or rows.device.type == "cpu":
        return scan_pieces_fused_ref(rows, tables, bound, start, wf=wf, halo=halo, n_rows=n_rows)
    if rows.device.type != "cuda":
        raise ValueError(f"no piece-scan kernel for device {rows.device}")
    global PIECE_LAUNCHES
    from ._build import check, library

    check_aligned_rows(rows)
    lib = library()
    dev = rows.device
    r_rows, p = rows.shape[0], tables.n_pat
    fcnt = torch.zeros((p,), dtype=torch.int32, device=dev)
    rowmap = torch.zeros((r_rows, p), dtype=torch.int32, device=dev)
    if min(n_rows, r_rows) == 0 or not tables.groups:
        return fcnt, rowmap
    span = wf + _PIECE_REACH
    grid = _grid(dev, min(n_rows, r_rows) * -(-span // _EXACT_SEG), _EXACT_BLOCKS_PER_SM)
    stream = torch.cuda.current_stream(dev).cuda_stream
    piece, plen, owner, prefix = tables.piece, tables.plen, tables.owner, tables.prefix
    for q0, q1, p0, p1 in tables.groups:
        err = lib.apm_pieces_fused_count(
            rows.data_ptr(), r_rows, rows.stride(0), n_rows,
            piece[q0].data_ptr(), q1 - q0, piece.shape[1], plen[q0].data_ptr(),
            owner[q0].data_ptr(), prefix[q0].data_ptr(), p0, p1 - p0, wf,
            int(bound), int(start), fcnt.data_ptr(), rowmap.data_ptr(), p, grid, stream,
        )
        check(err, "apm_pieces_fused_count")
        PIECE_LAUNCHES += 1
    return fcnt, rowmap


def scan_pieces_fused_ref(
    rows: torch.Tensor,
    tables: PieceTables,
    bound: int,
    start: int,
    *,
    wf: int,
    halo: int,
    n_rows: int,
):
    """Plain PyTorch version of kernel #7: for each piece, the AND of its
    bytes' compares against shifted slices of every row over the positions
    ``[0, wf + 64)``, hits summed per row and pattern, non-live rows
    zeroed."""
    _check_piece_rows(rows, wf, halo, n_rows, tables)
    dev = rows.device
    r_rows = rows.shape[0]
    width = wf + _PIECE_REACH
    rowpat = torch.zeros((r_rows, tables.n_pat), dtype=torch.int64, device=dev)
    piece = tables.piece.cpu().numpy()
    for q, (length, o) in enumerate(zip(tables.plen.tolist(), tables.owner.tolist())):
        if length <= 0:
            continue
        hit = rows[:, :width] == int(piece[q, 0])
        for i in range(1, length):
            hit &= rows[:, i : i + width] == int(piece[q, i])
        rowpat[:, o] += hit.sum(dim=1)
    r = torch.arange(r_rows, device=dev, dtype=torch.int64)
    live = (r < n_rows) & (start + r * wf < bound)
    rowpat *= live[:, None]
    return rowpat.sum(dim=0).to(torch.int32), (rowpat > 0).to(torch.int32)
