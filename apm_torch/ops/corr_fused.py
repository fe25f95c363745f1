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
from the same tables; the two compute the count two different ways.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .corr_engine import n_bitplanes

# Kernel launches made by scan_corr_fused.
LAUNCHES = 0

S_FUSED = 64
M_MAX_FUSED = 97  # m + 32 - 1 <= 128: one 128-byte K-tile per phase
_SINGLE_MAX = 1536  # apm's column-chunking threshold (pads P when above)
_INT8_MIN_SLOTS = 32  # apm's int8-operand threshold
_SENTINEL = 2**30  # threshold of padding slots: never reached

_PAT_GROUP = 8192  # slots per launch (32 KB of shared counters)
_BLOCKS_PER_SM = 8
_TILE = 256
# Staged rows per matmul group of the plain version (bounds its memory).
_REF_GROUP_BYTES = 256 << 20


def pick_s(m_max: int) -> int:
    """Phase stride of the tables: the widest S with m + S - 1 <= 128
    among {64, 32}."""
    return 64 if m_max <= 65 else 32


def fused_eligible(m_max: int, wf: int, halo: int) -> bool:
    """``apm``'s gate of the fused count kernel: m <= 97, lane-tiled
    staging rows and a >= 128-byte halo."""
    return (
        0 < m_max <= M_MAX_FUSED
        and wf % 128 == 0
        and halo % 128 == 0
        and halo >= 128
    )


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


@dataclass(frozen=True)
class FusedTables:
    """The fused tables on one device, with the pattern bytes kernel B
    reads (decoded from ``km``/``thr``/``alph`` once)."""

    km: torch.Tensor  # (B*128, s_ph*p) float32 or int8
    thr: torch.Tensor  # (1, s_ph*p) float32 or int32
    alph: torch.Tensor  # (C,) uint8, sorted pattern alphabet
    pat: torch.Tensor  # (p, m) uint8 decoded pattern bytes
    plen: torch.Tensor  # (p,) int32 decoded lengths, 0 = sentinel slot
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


def _launch(rows, tables, bound, start, wf, n_rows, p_out) -> torch.Tensor:
    global LAUNCHES
    from ._build import check, library

    lib = library()
    dev = rows.device
    rows = rows.contiguous()
    p = tables.p
    out = torch.zeros((max(p, p_out),), dtype=torch.int32, device=dev)
    live_rows = min(n_rows, rows.shape[0])
    if live_rows == 0:
        return out
    n_tiles = live_rows * -(-wf // _TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(n_tiles, sms * _BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(dev).cuda_stream
    pat, plen = tables.pat, tables.plen
    for g0 in range(0, p, _PAT_GROUP):
        ng = min(_PAT_GROUP, p - g0)
        err = lib.apm_corr_fused_count(
            rows.data_ptr(), rows.shape[0], rows.shape[1], n_rows,
            pat[g0].data_ptr(), ng, pat.shape[1], plen[g0].data_ptr(),
            wf, bound, start, out[g0].data_ptr(), grid, stream,
        )
        check(err, "apm_corr_fused_count")
        LAUNCHES += 1
    return out


def _encode_planes(rg: torch.Tensor, alph: torch.Tensor, b_planes: int):
    """±1 bit-plane encode ``(g, L) uint8 -> (g, B, L) float32``: plane b is
    +1 where bit b of the byte's alphabet code is set, -1 where clear, 0 for
    bytes outside the alphabet (``apm/ops/corr_engine.py::_encode_planes``)."""
    eq = rg[:, :, None] == alph[None, None, :]  # (g, L, C)
    valid = eq.any(dim=-1)
    code = (rg[:, :, None] > alph[None, None, :]).sum(dim=-1)  # rank = code
    bits = (code[:, None, :] >> torch.arange(b_planes, device=rg.device)[None, :, None]) & 1
    pm = (2 * bits - 1).to(torch.float32)
    return torch.where(valid[:, None, :], pm, torch.zeros((), device=rg.device))


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
    """Plain PyTorch version of kernel B: the TPU formulation.

    Windows come in phase blocks of ``s_ph``: the block at ``base`` (a
    multiple of ``s_ph``) reads the 128 text bytes ``[base, base + 128)``,
    encoded into B ±1 planes, and one matmul against ``km`` scores all
    ``s_ph * p`` (offset, pattern) columns; window ``base + s`` matches
    pattern ``q`` iff column ``s*p + q`` reaches ``thr``. Exactness: both
    matmul operands are in {-1, 0, 1} and every partial sum is an integer
    of magnitude <= B * 128 < 2**24, so the float32 matmul is exact under
    any float32 matmul precision (TF32 or bf16 inputs represent ±1 exactly,
    accumulation is float32).
    """
    _check_rows(rows, wf, halo, n_rows, tables)
    dev = rows.device
    s_ph, B, p = tables.s_ph, tables.b_planes, tables.p
    out = torch.zeros((max(p, p_out),), dtype=torch.int32, device=dev)
    live_rows = min(n_rows, rows.shape[0])
    if live_rows == 0:
        return out
    km = tables.km.to(torch.float32)  # (B*128, s_ph*p)
    thr = tables.thr.to(torch.float32).reshape(1, 1, -1)
    nb = wf // s_ph  # phase blocks per row that hold owned windows
    # Window offset of each column: s for column s*p + q.
    s_col = torch.arange(s_ph * p, device=dev) // p
    per_row = nb * max(B * 128, s_ph * p) * 4
    g = max(1, _REF_GROUP_BYTES // per_row)
    counts = torch.zeros((s_ph * p,), dtype=torch.int64, device=dev)
    for r0 in range(0, live_rows, g):
        rg = rows[r0 : min(r0 + g, live_rows)]
        planes = _encode_planes(rg, tables.alph, B)  # (g, B, L)
        # im2col: (g, B, nb, 128) -> (g*nb, B*128), plane-major like km.
        lhs = planes.unfold(2, 128, s_ph)[:, :, :nb]
        lhs = lhs.permute(0, 2, 1, 3).reshape(-1, B * 128)
        corr = (lhs @ km).reshape(rg.shape[0], nb, -1)  # (g, nb, s_ph*p)
        r = torch.arange(r0, r0 + rg.shape[0], device=dev, dtype=torch.int64)
        limit = (bound - start - r * wf).clamp(0, wf)  # (g,)
        base = torch.arange(nb, device=dev) * s_ph  # (nb,)
        j = base[None, :, None] + s_col[None, None, :]  # (1, nb, s_ph*p)
        match = (corr >= thr) & (j < limit[:, None, None])
        counts += match.sum(dim=(0, 1))
    out[:p] = counts.reshape(s_ph, p).sum(dim=0).to(torch.int32)
    return out
