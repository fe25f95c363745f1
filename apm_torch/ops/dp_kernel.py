"""Banded-DP window count: kernel A and its plain PyTorch version.

Port of ``apm/ops/pallas_kernel.py::scan_folded_pallas_unrolled`` in its
classic band mode (``_scan_folded_pallas_unrolled`` -> ``_scan_kernel_unrolled``
-> ``_band_phases``). Contract, shared by both functions here: staged rows
``(R, wf + halo)`` uint8 from :func:`apm_torch.ops.common.fold_corpus`, the
k-padded pattern table ``(P, m_max + 2k)`` uint8 and a static length tuple;
window ``j = start + r*wf + lane`` (``lane < wf``) counts for pattern ``p``
iff ``j < bound`` and its banded (``|d| <= k``) Levenshtein distance is
``<= k``. Returns ``(P,)`` int32 counts; padding patterns (length 0) count
nothing.

:func:`scan_folded_dp` launches the CUDA kernel (``csrc/dp_band.cu``) for a
CUDA tensor and uses :func:`scan_folded_dp_ref` only for a CPU tensor.
``apm``'s bit-parallel (Myers) mode gives the same counts and is not ported
yet (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Sequence

import torch

# Kernel launches made by scan_folded_dp (the count a run reads to show
# that its scans went through the kernel).
LAUNCHES = 0

# Patterns per launch: bounds the kernel's shared per-pattern counters to
# 32 KB, under the default dynamic shared-memory limit.
_PAT_GROUP = 8192
# Resident blocks per SM the grid is sized for (256 threads each).
_BLOCKS_PER_SM = 8
# Wide bands (ke > 16) keep their cells in global scratch; this caps it.
_SCRATCH_BYTES = 256 << 20
_TILE = 256  # threads (= windows) per block, apm::kTile


def _check_args(rows, pat, k, m_max, wf, halo, plens) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be 2-D uint8, got {rows.dtype} {tuple(rows.shape)}")
    if rows.shape[1] != wf + halo or rows.shape[0] <= 0:
        raise ValueError(f"rows shape {tuple(rows.shape)} != (R, wf + halo = {wf + halo})")
    if halo < m_max - 1:
        raise ValueError(f"halo {halo} < m_max - 1 = {m_max - 1}")
    if pat.dtype != torch.uint8 or pat.dim() != 2 or pat.shape[1] != m_max + 2 * k:
        raise ValueError(
            f"pat must be uint8 (P, m_max + 2k = {m_max + 2 * k}), got "
            f"{pat.dtype} {tuple(pat.shape)}"
        )
    if len(plens) != pat.shape[0]:
        raise ValueError(f"{len(plens)} lengths for {pat.shape[0]} patterns")
    if any(m < 0 or m > m_max for m in plens):
        raise ValueError(f"pattern lengths must lie in [0, {m_max}]: {plens}")
    if pat.device != rows.device:
        raise ValueError(f"rows on {rows.device}, pat on {pat.device}")


def scan_folded_dp(
    rows: torch.Tensor,
    pat: torch.Tensor,
    bound: int,
    start: int,
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
    plens: Sequence[int],
) -> torch.Tensor:
    """(P,) int32 banded-DP counts of this chunk (module contract).

    CUDA tensors go to the kernel (launched on the current stream, no
    synchronisation); CPU tensors to :func:`scan_folded_dp_ref`.
    """
    plens = tuple(int(m) for m in plens)
    _check_args(rows, pat, k, m_max, wf, halo, plens)
    if rows.device.type == "cpu":
        return scan_folded_dp_ref(
            rows, pat, bound, start, k=k, m_max=m_max, wf=wf, halo=halo,
            plens=plens,
        )
    if rows.device.type != "cuda":
        raise ValueError(f"no banded-DP kernel for device {rows.device}")
    return _launch(rows, pat, int(bound), int(start), k, m_max, wf, plens)


def _launch(rows, pat, bound, start, k, m_max, wf, plens) -> torch.Tensor:
    global LAUNCHES
    from ._build import check, library

    lib = library()
    dev = rows.device
    rows = rows.contiguous()
    pat = pat.contiguous()
    n_pat = pat.shape[0]
    out = torch.zeros((n_pat,), dtype=torch.int32, device=dev)
    if not any(plens):
        return out
    # Lengths travel with the launch; a pageable non-blocking copy stages
    # on the host and does not wait for the stream.
    dplen = torch.tensor(plens, dtype=torch.int32).to(dev, non_blocking=True)
    ke = min(k, m_max)
    n_tiles = rows.shape[0] * -(-wf // _TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(n_tiles, sms * _BLOCKS_PER_SM))
    scratch = None
    if ke > lib.apm_dp_band_reg_max():
        slab = (2 * ke + 1) * _TILE * 4
        grid = max(1, min(grid, _SCRATCH_BYTES // slab))
        scratch = torch.empty((grid * slab // 4,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for g0 in range(0, n_pat, _PAT_GROUP):
        ng = min(_PAT_GROUP, n_pat - g0)
        if not any(plens[g0 : g0 + ng]):
            continue
        err = lib.apm_dp_band_count(
            rows.data_ptr(), rows.shape[0], rows.shape[1],
            pat[g0].data_ptr(), ng, pat.shape[1], dplen[g0].data_ptr(),
            k, ke, wf, bound, start,
            out[g0].data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            grid, stream,
        )
        check(err, "apm_dp_band_count")
        LAUNCHES += 1
    return out


def scan_folded_dp_ref(
    rows: torch.Tensor,
    pat: torch.Tensor,
    bound: int,
    start: int,
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
    plens: Sequence[int],
) -> torch.Tensor:
    """Plain PyTorch version of kernel A, on any device.

    The clamped band of ``apm/ops/xla_engine.py::scan_block_xla``: one
    step loop over ``x`` advancing every live pattern's ``2k + 1``
    diagonals as ``(P_live, R, wf)`` int32 tensors, cells clamped at
    ``k + 1``, ``D[m_p][m_p]`` captured at step ``x == m_p``.
    """
    plens = tuple(int(m) for m in plens)
    _check_args(rows, pat, k, m_max, wf, halo, plens)
    dev = rows.device
    out = torch.zeros((len(plens),), dtype=torch.int32, device=dev)
    live = [p for p, m in enumerate(plens) if m > 0]
    if not live:
        return out
    n_rows = rows.shape[0]
    cap = k + 1
    lens = [plens[p] for p in live]
    pl = pat[live].to(torch.int32)  # (L, m_max + 2k)
    shape = (len(live), n_rows, wf)
    band = [
        torch.full(shape, d if d >= 0 else cap, dtype=torch.int32, device=dev)
        for d in range(-k, k + 1)
    ]
    res = torch.full(shape, cap, dtype=torch.int32, device=dev)
    for x in range(1, max(lens) + 1):
        tx = rows[:, x - 1 : x - 1 + wf].to(torch.int32)[None]  # (1, R, wf)
        prev = None
        new = []
        for di in range(2 * k + 1):
            y = x + di - k
            if y == 0:
                v = torch.full(shape, min(x, cap), dtype=torch.int32, device=dev)
            else:
                pc = pl[:, x - 1 + di].view(-1, 1, 1)
                v = band[di] + (tx != pc).to(torch.int32)
                if di < 2 * k:
                    v = torch.minimum(v, band[di + 1] + 1)
                if prev is not None:
                    v = torch.minimum(v, prev + 1)
                v = v.clamp_max_(cap)
            new.append(v)
            prev = v
        band = new
        for i, m in enumerate(lens):
            if m == x:
                res[i] = band[k][i]
    lane = torch.arange(wf, device=dev, dtype=torch.int64)
    row = torch.arange(n_rows, device=dev, dtype=torch.int64)
    valid = (start + row[:, None] * wf + lane[None, :]) < bound  # (R, wf)
    hits = (res <= k) & valid[None]
    out[live] = hits.sum(dim=(1, 2)).to(torch.int32)
    return out
