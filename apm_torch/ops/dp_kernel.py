"""Banded-DP window count: kernels A (band) and C (Myers) and their plain
PyTorch versions, each in three modes.

Port of ``apm/ops/pallas_kernel.py::scan_folded_pallas_unrolled`` in both of
its modes (``_scan_folded_pallas_unrolled`` -> ``_scan_kernel_unrolled`` ->
``_band_phases`` or ``_myers_phases``). Contract, shared by every function
here: staged rows ``(R, wf + halo)`` uint8 from
:func:`apm_torch.ops.common.fold_corpus`, the k-padded pattern table
``(P, m_max + 2k)`` uint8 and a static length tuple; window
``j = start + r*wf + lane`` (``lane < wf``) counts for pattern ``p`` iff
``j < bound`` and its banded (``|d| <= k``) Levenshtein distance is
``<= k``. Returns ``(P,)`` int32 counts; padding patterns (length 0) count
nothing. ``bound`` is an int, or a 0-d integer tensor on the rows' device
(phase-2 verification, whose bound is only known on the device).

Two more modes (``Scanner.count_batch`` and ``Scanner.find``):

* batch (:func:`scan_folded_dp_batch`, ``apm``'s ``_scan_folded_pallas_batch``,
  TPU kernel #4): rows of many corpora, one ``[bound, start]`` pair per block
  of :data:`FOLD` rows (``meta``, ``(R/8, 2)`` int32); window
  ``meta[b, 1] + (r % 8)*wf + lane`` of row ``r`` in block ``b = r // 8``
  counts iff it is below ``meta[b, 0]``. Returns ``(R/8, P)`` int32.
* mask (:func:`scan_folded_dp_mask`, ``_scan_folded_pallas_mask``, TPU kernel
  #6): the counts, and every window's verdict as ``(R, P, wf)`` uint8
  (``apm``'s int8 mask after its transpose), 0 for padding patterns and
  windows past the bound; kernels of its own (``csrc/dp_mask.cu``), one
  for each mode.

A fourth entry has dynamic lengths (:func:`scan_folded`, ``apm``'s
``scan_folded_pallas``, TPU kernel #9; ``apm_torch.graft_entry.entry()``):
the count of the module contract with the lengths as an ``(P,)`` integer
tensor on the rows' device, which the card path never reads on the host,
every staged row count a multiple of :data:`FOLD`, and ``bound`` and
``start`` ints or 0-d tensors. It runs kernel A's count mode through a C
entry of its own (``apm_dp_band_dyn``) and has its own plain version
(:func:`scan_folded_ref`).

The mode is ``apm``'s static dispatch (:func:`_myers_mode`): the
bit-parallel band for 1 <= k <= 14 with a pattern alphabet of at most 8
bytes and a PEQ table of at most 64 KB, under ``dp_impl="auto"`` only from
``k >= MYERS_KMIN_AUTO``. Both modes give the same counts.

The public functions launch kernel C (``csrc/dp_myers.cu``) or kernel A
(``csrc/dp_band.cu``) for a CUDA tensor, as that dispatch decides (the mask
mode: the two mask kernels of ``csrc/dp_mask.cu``; all of them walk tiles
of two windows a thread on ``csrc/dp_pair.cuh``, and size their own grid),
and run the plain version of the chosen mode for a CPU tensor, or on any
device when the caller asks for it (``plain=True``, the Scanner's
``backend="torch"``).
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import numpy as np
import torch

# Kernel launches (the counts a run reads to show that its scans went
# through the kernels): kernel A and kernel C in count mode, the batch mode
# of either, and the mask kernels (#6, either mode).
LAUNCHES = 0
MYERS_LAUNCHES = 0
BATCH_LAUNCHES = 0
MASK_LAUNCHES = 0
DYN_LAUNCHES = 0  # kernel A through the dynamic-length entry (#9)

# apm's Myers-mode constants (measured on its TPU; copied so both packages
# pick the same mode — re-measuring them on the H100 is open work).
MYERS_KMIN_AUTO = 3
MYERS_KMAX = 14  # band width 2k + 1 <= 29 bits
MYERS_CMAX = 8  # alphabet channels
MYERS_SMEM_MAX = 64 * 1024  # PEQ table budget (bytes)

FOLD = 8  # rows per block of the batch mode (apm's int32 fold)

# Patterns per launch: bounds the kernel's shared per-pattern counters to
# 32 KB, under the default dynamic shared-memory limit.
_PAT_GROUP = 8192
# Band mode: a launch stages its patterns' table, 4 bytes a byte, in
# shared memory when it fits 32 KB (csrc/dp_pair.cuh's kTableBytes), else
# reads it from global memory, so patterns go to launches in groups that
# fit, or all together when one pattern alone does not.
_TABLE_BYTES = 32 << 10
# Wide bands (ke > 16) keep their cells in global scratch; this caps it.
_SCRATCH_BYTES = 256 << 20
_THREADS = 256  # threads per block of the pair kernels, apm::kTile

Bound = Union[int, torch.Tensor]


def _myers_mode(
    k: int, alphabet: tuple, dp_dtype: str, dp_impl: str, p: int, m_max: int
) -> bool:
    """Run the bit-parallel band instead of the classic band?
    ``dp_impl``: "auto" (``k >= MYERS_KMIN_AUTO``), "band" (never),
    "myers" (whenever representable)."""
    if dp_impl == "band" or not alphabet or dp_dtype != "int32":
        return False
    if not (1 <= k <= MYERS_KMAX) or len(alphabet) > MYERS_CMAX:
        return False
    if k >= m_max:  # the static phase reads PEQ row k
        return False
    if p * m_max * len(alphabet) * 4 > MYERS_SMEM_MAX:
        return False
    return True if dp_impl == "myers" else k >= MYERS_KMIN_AUTO


def resolve_dp_mode(
    k: int, alphabet: tuple, dp_dtype: str, dp_impl: str, p: int, m_max: int
) -> tuple:
    """``(alphabet, "myers")`` when the bit-parallel mode is on, else
    ``((), "band")`` — ``apm``'s normalisation of the mode keys."""
    if _myers_mode(k, alphabet, dp_dtype, dp_impl, p, m_max):
        return tuple(alphabet), "myers"
    return (), "band"


def build_peq(pat: np.ndarray, k: int, m_max: int, alphabet) -> np.ndarray:
    """Match-bit table of the bit-parallel band, ``(P*m_max, C)`` int32:
    ``peq[p*m_max + X, c]`` bit ``b`` is set iff ``pat[p, X + b] ==
    alphabet[c]`` (``pat`` is the k-padded table, so ``X`` indexes DP
    steps: the moving band at step x reads row ``x - 1``, the static phase
    row ``k``)."""
    pat = np.asarray(pat)
    B = 2 * k + 1
    p = pat.shape[0]
    p64 = pat.astype(np.int64)
    wins = np.stack([p64[:, X : X + B] for X in range(m_max)], axis=1)
    eq = wins[..., None] == np.asarray(alphabet, np.int64)  # (P, m, B, C)
    bits = eq.astype(np.int64) << np.arange(B, dtype=np.int64).reshape(1, 1, B, 1)
    return bits.sum(axis=2).reshape(p * m_max, len(alphabet)).astype(np.int32)


def _check_args(rows, pat, bound, k, m_max, wf, halo, plens) -> None:
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
    if isinstance(bound, torch.Tensor) and (
        bound.numel() != 1 or bound.device != rows.device
        or bound.dtype not in (torch.int32, torch.int64)
    ):
        raise ValueError(
            f"a tensor bound must be one int32/int64 value on {rows.device}, "
            f"got {bound.dtype} {tuple(bound.shape)} on {bound.device}"
        )


def _check_meta(rows, meta) -> None:
    want = (rows.shape[0] // FOLD, 2)
    if rows.shape[0] % FOLD:
        raise ValueError(f"batch rows {rows.shape[0]} are not a multiple of {FOLD}")
    if (
        not isinstance(meta, torch.Tensor) or tuple(meta.shape) != want
        or meta.dtype != torch.int32 or meta.device != rows.device
    ):
        raise ValueError(
            f"meta must be int32 {want} on {rows.device}, got "
            f"{getattr(meta, 'dtype', type(meta))} {tuple(getattr(meta, 'shape', ()))}"
        )


def _is_myers(k, m_max, plens, alphabet, dp_impl) -> bool:
    return _myers_mode(k, tuple(alphabet), "int32", dp_impl, len(plens), m_max)


def _peq_tensor(pat, peq, k, m_max, alphabet) -> torch.Tensor:
    """The PEQ table on the rows' device: ``peq`` as given, else built from
    ``pat`` (a device-to-host copy; the Scanner passes its own table)."""
    if peq is None:
        peq = torch.from_numpy(build_peq(pat.cpu().numpy(), k, m_max, alphabet))
    want = (pat.shape[0] * m_max, len(alphabet))
    if tuple(peq.shape) != want or peq.dtype != torch.int32:
        raise ValueError(f"peq must be int32 {want}, got {peq.dtype} {tuple(peq.shape)}")
    return peq.to(pat.device).contiguous()


def _dispatch(rows, pat, bound, start, meta, mask, *, k, m_max, wf, halo, plens,
              alphabet, dp_impl, peq, plain):
    """Shared dispatch of the three modes: one mode decision, then kernel C
    or A for a CUDA tensor, else the plain version of that mode."""
    plens = tuple(int(m) for m in plens)
    _check_args(rows, pat, bound, k, m_max, wf, halo, plens)
    if meta is not None:
        _check_meta(rows, meta)
    myers = _is_myers(k, m_max, plens, alphabet, dp_impl)
    if plain or rows.device.type == "cpu":
        kw = dict(k=k, m_max=m_max, wf=wf, halo=halo, plens=plens)
        mode = dict(alphabet=alphabet, dp_impl=dp_impl, peq=peq)
        if meta is not None:
            return scan_folded_dp_batch_ref(rows, pat, meta, **mode, **kw)
        if mask:
            return scan_folded_dp_mask_ref(rows, pat, bound, start, **mode, **kw)
        if myers:
            return scan_folded_myers_ref(rows, pat, bound, start, alphabet=alphabet, peq=peq, **kw)
        return scan_folded_dp_ref(rows, pat, bound, start, **kw)
    if rows.device.type != "cuda":
        raise ValueError(f"no banded-DP kernel for device {rows.device}")
    if myers:
        peq = _peq_tensor(pat, peq, k, m_max, alphabet)
        return _launch_myers(rows, peq, bound, int(start), k, m_max, wf, plens,
                             alphabet, meta, mask)
    return _launch(rows, pat, bound, int(start), k, m_max, wf, plens, meta, mask)


def scan_folded_dp(
    rows: torch.Tensor,
    pat: torch.Tensor,
    bound: Bound,
    start: int,
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
    plens: Sequence[int],
    alphabet: Sequence[int] = (),
    dp_impl: str = "auto",
    peq: torch.Tensor = None,
    plain: bool = False,
) -> torch.Tensor:
    """(P,) int32 banded-DP counts of this chunk (module contract).

    CUDA tensors go to kernel C (Myers mode) or kernel A, launched on the
    current stream without synchronisation; CPU tensors, and any tensor
    under ``plain=True``, to the plain version of the same mode. ``peq``
    is the Myers-mode table (:func:`build_peq`), built from ``pat`` when
    not given.
    """
    return _dispatch(rows, pat, bound, start, None, False, k=k, m_max=m_max,
                     wf=wf, halo=halo, plens=plens, alphabet=alphabet,
                     dp_impl=dp_impl, peq=peq, plain=plain)


def scan_folded_dp_batch(
    rows: torch.Tensor,
    pat: torch.Tensor,
    meta: torch.Tensor,
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
    plens: Sequence[int],
    alphabet: Sequence[int] = (),
    dp_impl: str = "auto",
    peq: torch.Tensor = None,
    plain: bool = False,
) -> torch.Tensor:
    """(R/8, P) int32 per-block counts of a batch (module doc, batch mode):
    the batch mode of kernel C or A, as :func:`scan_folded_dp` dispatches."""
    return _dispatch(rows, pat, 0, 0, meta, False, k=k, m_max=m_max, wf=wf,
                     halo=halo, plens=plens, alphabet=alphabet,
                     dp_impl=dp_impl, peq=peq, plain=plain)


def scan_folded_dp_mask(
    rows: torch.Tensor,
    pat: torch.Tensor,
    bound: Bound,
    start: int,
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
    plens: Sequence[int],
    alphabet: Sequence[int] = (),
    dp_impl: str = "auto",
    peq: torch.Tensor = None,
    plain: bool = False,
):
    """``(counts (P,) int32, mask (R, P, wf) uint8)`` of this chunk (module
    doc, mask mode): the Myers or band mask kernel (``csrc/dp_mask.cu``),
    as :func:`scan_folded_dp` dispatches."""
    return _dispatch(rows, pat, bound, start, None, True, k=k, m_max=m_max,
                     wf=wf, halo=halo, plens=plens, alphabet=alphabet,
                     dp_impl=dp_impl, peq=peq, plain=plain)


def _bound_args(bound: Bound, dev):
    """``(value, pointer, keep-alive)`` of a bound for the C entries."""
    if isinstance(bound, torch.Tensor):
        dbound = bound.to(device=dev, dtype=torch.int64).reshape(())
        return 0, dbound.data_ptr(), dbound
    return int(bound), None, None


def _wide_scratch(lib, dev, n_rows: int, wf: int, ke: int):
    """``(grid cap, scratch)`` of a band launch: ``(0, None)`` (the entry
    sizes its grid) unless the band is wider than the register path, whose
    int32 cells take a global slab a block; then the entry's own grid
    (``apm_dp_mask_grid``), cut to fit ``_SCRATCH_BYTES``."""
    from ._build import check

    if ke <= lib.apm_dp_band_reg_max():
        return 0, None
    grid = lib.apm_dp_mask_grid(n_rows, wf, ke)
    check(0 if grid > 0 else -grid, "apm_dp_mask_grid")
    slab = (2 * ke + 1) * _THREADS * 4
    grid = max(1, min(grid, _SCRATCH_BYTES // slab))
    return grid, torch.empty((grid * slab // 4,), dtype=torch.int32, device=dev)


@functools.lru_cache(maxsize=64)
def _device_consts(plens: tuple, alphabet: tuple, dev: torch.device):
    """``(lengths int32, alphabet uint8 or None)`` on ``dev``, copied once
    per ``(plens, alphabet, device)``: a launch sends no host-to-device
    copy of its own."""
    dplen = torch.tensor(plens, dtype=torch.int32, device=dev)
    alph = torch.tensor(alphabet, dtype=torch.uint8, device=dev) if alphabet else None
    return dplen, alph


def _table_group(pat_stride: int) -> int:
    """Patterns a band launch takes (see ``_TABLE_BYTES``)."""
    return _TABLE_BYTES // (4 * pat_stride) or _PAT_GROUP


def _outputs(rows, n_pat, wf, meta, mask):
    """Zeroed counts ((P,), or (R/8, P) in batch mode) and, in mask mode,
    the mask the kernel fills cell by cell."""
    dev = rows.device
    shape = (rows.shape[0] // FOLD, n_pat) if meta is not None else (n_pat,)
    out = torch.zeros(shape, dtype=torch.int32, device=dev)
    vmask = torch.empty((rows.shape[0], n_pat, wf), dtype=torch.uint8, device=dev) if mask else None
    return out, vmask


def _result(out, vmask, plens):
    if vmask is None:
        return out
    if not any(plens):  # nothing launched
        vmask.zero_()
    return out, vmask


def _launch(rows, pat, bound, start, k, m_max, wf, plens, meta=None, mask=False):
    """Kernel A in count or batch (``meta``) mode, or the band mask kernel
    (``csrc/dp_mask.cu``)."""
    global LAUNCHES, BATCH_LAUNCHES, MASK_LAUNCHES
    from ._build import check, library

    lib = library()
    dev = rows.device
    rows = rows.contiguous()
    pat = pat.contiguous()
    n_rows, n_pat = rows.shape[0], pat.shape[0]
    out, vmask = _outputs(rows, n_pat, wf, meta, mask)
    if not any(plens):
        return _result(out, vmask, plens)
    dplen, _ = _device_consts(plens, (), dev)
    bval, bptr, _keep = _bound_args(bound, dev)
    ke = min(k, m_max)
    grid, scratch = _wide_scratch(lib, dev, n_rows, wf, ke)
    sptr = scratch.data_ptr() if scratch is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (rows.data_ptr(), n_rows, rows.shape[1])
    group = _table_group(pat.shape[1])
    for g0 in range(0, n_pat, group):
        ng = min(group, n_pat - g0)
        # Mask mode launches every group: its verdicts are zeros too.
        if not any(plens[g0 : g0 + ng]) and vmask is None:
            continue
        pats = (pat[g0].data_ptr(), ng, pat.shape[1], dplen[g0].data_ptr(), k, ke, wf)
        if meta is not None:
            err = lib.apm_dp_band_batch(
                *head, *pats, meta.data_ptr(), out.data_ptr() + 4 * g0, n_pat,
                sptr, grid, stream,
            )
            check(err, "apm_dp_band_batch")
            BATCH_LAUNCHES += 1
        elif vmask is not None:
            err = lib.apm_dp_band_mask(
                *head, *pats, bval, bptr, start, out[g0].data_ptr(),
                vmask.data_ptr() + g0 * wf, n_pat * wf, sptr, grid, stream,
            )
            check(err, "apm_dp_band_mask")
            MASK_LAUNCHES += 1
        else:
            err = lib.apm_dp_band_count(
                *head, *pats, bval, bptr, start, out[g0].data_ptr(), sptr,
                grid, stream,
            )
            check(err, "apm_dp_band_count")
            LAUNCHES += 1
    return _result(out, vmask, plens)


def _launch_myers(rows, peq, bound, start, k, m_max, wf, plens, alphabet,
                  meta=None, mask=False):
    """Kernel C in count or batch (``meta``) mode, or the Myers mask kernel
    (``csrc/dp_mask.cu``)."""
    global MYERS_LAUNCHES, BATCH_LAUNCHES, MASK_LAUNCHES
    from ._build import check, library

    lib = library()
    dev = rows.device
    rows = rows.contiguous()
    n_pat = len(plens)
    out, vmask = _outputs(rows, n_pat, wf, meta, mask)
    if not any(plens):
        return _result(out, vmask, plens)
    dplen, alph = _device_consts(plens, tuple(int(a) for a in alphabet), dev)
    bval, bptr, _keep = _bound_args(bound, dev)
    head = (
        rows.data_ptr(), rows.shape[0], rows.shape[1], peq.data_ptr(), n_pat,
        m_max, len(alphabet), alph.data_ptr(), dplen.data_ptr(), k, wf,
    )
    tail = (0, torch.cuda.current_stream(dev).cuda_stream)  # 0: the entry sizes its grid
    if meta is not None:
        err = lib.apm_dp_myers_batch(*head, meta.data_ptr(), out.data_ptr(), n_pat, *tail)
        check(err, "apm_dp_myers_batch")
        BATCH_LAUNCHES += 1
    elif vmask is not None:
        err = lib.apm_dp_myers_mask(
            *head, bval, bptr, start, out.data_ptr(), vmask.data_ptr(), n_pat * wf, *tail
        )
        check(err, "apm_dp_myers_mask")
        MASK_LAUNCHES += 1
    else:
        err = lib.apm_dp_myers_count(*head, bval, bptr, start, out.data_ptr(), *tail)
        check(err, "apm_dp_myers_count")
        MYERS_LAUNCHES += 1
    return _result(out, vmask, plens)


def _check_dyn(rows, pat, plen, bound, start, k, m_max, wf, halo) -> None:
    """``scan_folded_pallas``'s asserts, as errors, and the tensor checks."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be 2-D uint8, got {rows.dtype} {tuple(rows.shape)}")
    if rows.shape[1] != wf + halo or rows.shape[0] <= 0 or rows.shape[0] % FOLD:
        raise ValueError(
            f"rows shape {tuple(rows.shape)}: need (R, wf + halo = {wf + halo}), "
            f"R a positive multiple of {FOLD}"
        )
    if halo < m_max - 1:
        raise ValueError(f"halo {halo} < m_max - 1 = {m_max - 1}")
    if pat.dtype != torch.uint8 or pat.dim() != 2 or pat.shape[1] != m_max + 2 * k:
        raise ValueError(
            f"pat must be uint8 (P, m_max + 2k = {m_max + 2 * k}), got "
            f"{pat.dtype} {tuple(pat.shape)}"
        )
    if (
        not isinstance(plen, torch.Tensor) or tuple(plen.shape) != (pat.shape[0],)
        or plen.dtype not in (torch.int32, torch.int64)
    ):
        raise ValueError(f"plen must be an int32/int64 ({pat.shape[0]},) tensor")
    for name, t in (("pat", pat), ("plen", plen)):
        if t.device != rows.device:
            raise ValueError(f"rows on {rows.device}, {name} on {t.device}")
    for name, v in (("bound", bound), ("start", start)):
        if isinstance(v, torch.Tensor) and (
            v.numel() != 1 or v.device != rows.device
            or v.dtype not in (torch.int32, torch.int64)
        ):
            raise ValueError(f"a tensor {name} must be one int32/int64 value on {rows.device}")


def scan_folded(
    rows: torch.Tensor,
    pat: torch.Tensor,
    plen: torch.Tensor,
    bound: Bound,
    start: Union[int, torch.Tensor],
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
) -> torch.Tensor:
    """(P,) int32 counts of windows in ``[start, bound)`` with dynamic
    pattern lengths (module doc; ``apm``'s ``scan_folded_pallas``).

    ``plen`` values must lie in ``[0, m_max]``: the plain version checks
    it; the kernel cannot without a host sync, and counts nothing for a
    length outside ``[1, m_max]``, as ``apm``'s kernel does. CUDA tensors
    go to kernel A's dynamic-length entry (current stream, no
    synchronisation, nothing read back to the host); CPU tensors to
    :func:`scan_folded_ref`.
    """
    _check_dyn(rows, pat, plen, bound, start, k, m_max, wf, halo)
    if rows.device.type == "cpu":
        return scan_folded_ref(rows, pat, plen, bound, start, k=k, m_max=m_max, wf=wf, halo=halo)
    if rows.device.type != "cuda":
        raise ValueError(f"no banded-DP kernel for device {rows.device}")
    global DYN_LAUNCHES
    from ._build import check, library

    lib = library()
    dev = rows.device
    rows = rows.contiguous()
    pat = pat.contiguous()
    dplen = plen.to(torch.int32).contiguous()
    n_rows, n_pat = rows.shape[0], pat.shape[0]
    out = torch.zeros((n_pat,), dtype=torch.int32, device=dev)
    bval, bptr, _keep_b = _bound_args(bound, dev)
    sval, sptr, _keep_s = _bound_args(start, dev)
    ke = min(k, m_max)
    grid, scratch = _wide_scratch(lib, dev, n_rows, wf, ke)
    sptr_scratch = scratch.data_ptr() if scratch is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    group = _table_group(pat.shape[1])
    for g0 in range(0, n_pat, group):
        ng = min(group, n_pat - g0)
        err = lib.apm_dp_band_dyn(
            rows.data_ptr(), n_rows, rows.shape[1], pat[g0].data_ptr(), ng,
            pat.shape[1], dplen[g0].data_ptr(), k, ke, wf, bval, bptr, sval,
            sptr, out[g0].data_ptr(), sptr_scratch, grid, stream,
        )
        check(err, "apm_dp_band_dyn")
        DYN_LAUNCHES += 1
    return out


# -- plain versions -----------------------------------------------------------


def _valid(rows, bound, start, wf) -> torch.Tensor:
    """(R, wf) window ownership ``start + r*wf + lane < bound``."""
    dev = rows.device
    lane = torch.arange(wf, device=dev, dtype=torch.int64)
    row = torch.arange(rows.shape[0], device=dev, dtype=torch.int64)
    return (start + row[:, None] * wf + lane[None, :]) < bound


def _valid_batch(meta, n_rows, wf) -> torch.Tensor:
    """(R, wf) window ownership of the batch mode: row ``r`` of block
    ``b = r // 8`` owns lane ``l`` iff ``meta[b, 1] + (r % 8)*wf + l <
    meta[b, 0]``."""
    dev = meta.device
    m = meta.to(torch.int64).repeat_interleave(FOLD, dim=0)  # (R, 2)
    sub = torch.arange(n_rows, device=dev, dtype=torch.int64) % FOLD
    lane = torch.arange(wf, device=dev, dtype=torch.int64)
    return (m[:, 1:2] + sub[:, None] * wf + lane[None, :]) < m[:, 0:1]


def _reduce(hits, rows, bound, start, meta, mask, wf):
    """The plain versions' outputs from the ``(P, R, wf)`` verdicts."""
    if meta is not None:
        hits = hits & _valid_batch(meta, rows.shape[0], wf)[None]
        p, r = hits.shape[0], hits.shape[1]
        return hits.reshape(p, r // FOLD, FOLD * wf).sum(dim=2).to(torch.int32).t().contiguous()
    hits = hits & _valid(rows, bound, start, wf)[None]
    counts = hits.sum(dim=(1, 2)).to(torch.int32)
    if mask:
        return counts, hits.permute(1, 0, 2).to(torch.uint8).contiguous()
    return counts


def _band_verdicts(rows, pat, *, k, wf, plens) -> torch.Tensor:
    """Verdicts of the clamped band of ``apm/ops/xla_engine.py::
    scan_block_xla``: one step loop over ``x`` advancing every live
    pattern's diagonals as ``(P_live, R, wf)`` int32 tensors, cells clamped
    at ``k + 1``, ``D[m_p][m_p]`` captured at step ``x == m_p``. Only the
    ``2 ke + 1`` diagonals ``|d| <= ke = min(k, max m_p)`` are kept, as the
    kernels keep them: ``D[m][m]`` reads cells with ``0 <= x, y <= m``
    alone, so wider diagonals never reach it, and the verdict is ``apm``'s
    at every k (at k >= 16383 the band would otherwise hold 32 767
    tensors)."""
    dev = rows.device
    out = torch.zeros((len(plens), rows.shape[0], wf), dtype=torch.bool, device=dev)
    live = [p for p, m in enumerate(plens) if m > 0]
    if not live:
        return out
    n_rows = rows.shape[0]
    cap = k + 1
    lens = [plens[p] for p in live]
    ke = min(k, max(lens))
    pl = pat[live].to(torch.int32)[:, k - ke :]  # (L, m_max + k + ke): column y - 1 + ke
    shape = (len(live), n_rows, wf)
    band = [
        torch.full(shape, d if d >= 0 else cap, dtype=torch.int32, device=dev)
        for d in range(-ke, ke + 1)
    ]
    res = torch.full(shape, cap, dtype=torch.int32, device=dev)
    for x in range(1, max(lens) + 1):
        tx = rows[:, x - 1 : x - 1 + wf].to(torch.int32)[None]  # (1, R, wf)
        prev = None
        new = []
        for di in range(2 * ke + 1):
            y = x + di - ke
            if y == 0:
                v = torch.full(shape, min(x, cap), dtype=torch.int32, device=dev)
            else:
                pc = pl[:, x - 1 + di].view(-1, 1, 1)
                v = band[di] + (tx != pc).to(torch.int32)
                if di < 2 * ke:
                    v = torch.minimum(v, band[di + 1] + 1)
                if prev is not None:
                    v = torch.minimum(v, prev + 1)
                v = v.clamp_max_(cap)
            new.append(v)
            prev = v
        band = new
        for i, m in enumerate(lens):
            if m == x:
                res[i] = band[ke][i]
    out[live] = res <= k
    return out


def _myers_verdicts(rows, pat, *, k, m_max, wf, plens, alphabet, peq) -> torch.Tensor:
    """Verdicts of ``apm``'s ``_myers_phases`` per pattern, ``VP``/``VN``/
    centre as ``(R, wf)`` int64 tensors. The match word of a step is the
    PEQ row's entry for the text byte's alphabet channel (0 outside the
    alphabet)."""
    alphabet = tuple(int(a) for a in alphabet)
    if not alphabet or not 1 <= k <= MYERS_KMAX or k >= m_max:
        raise ValueError(f"Myers mode needs an alphabet and 1 <= k <= {MYERS_KMAX}, k < m_max")
    dev = rows.device
    out = torch.zeros((len(plens), rows.shape[0], wf), dtype=torch.bool, device=dev)
    if not any(plens):
        return out
    n_chan = len(alphabet)
    peq = _peq_tensor(pat, peq, k, m_max, alphabet).to(torch.int64)
    # Channel C of every row is the zero word of bytes outside the alphabet.
    peq = torch.cat([peq, torch.zeros_like(peq[:, :1])], dim=1)
    lut = torch.full((256,), n_chan, dtype=torch.int64, device=dev)
    lut[torch.tensor(alphabet, device=dev)] = torch.arange(n_chan, device=dev)
    chan = lut[rows[:, : wf + m_max - 1].to(torch.int64)]  # (R, wf + m - 1)
    bw = 2 * k + 1
    mask = (1 << bw) - 1
    topbit = 1 << (bw - 1)

    def step(vp, vn, cc, eq, cbit):
        xv = eq | vn
        xh = (((eq & vp) + vp) ^ vp) | eq
        ph = vn | (~(xh | vp) & mask)
        mh = vp & xh
        ph = ((ph << 1) & mask) | 1
        mh = (mh << 1) & mask
        cc = cc + (1 - (((xh | vn) >> cbit) & 1))
        return mh | (~(xv | ph) & mask), ph & xv, cc

    shape = (rows.shape[0], wf)
    for p, m in enumerate(plens):
        if m == 0:
            continue
        vp = torch.full(shape, mask, dtype=torch.int64, device=dev)
        vn = torch.zeros(shape, dtype=torch.int64, device=dev)
        cc = torch.zeros(shape, dtype=torch.int64, device=dev)
        base = p * m_max
        for x in range(1, min(k, m) + 1):  # static band: PEQ row k
            eq = peq[base + k][chan[:, x - 1 : x - 1 + wf]]
            vp, vn, cc = step(vp, vn, cc, eq, x - 1)
        if m > k:  # re-index onto the moving band
            vp = ((vp << 1) | 1) & mask
            vn = (vn << 1) & mask
            for x in range(k + 1, m + 1):
                vp = (vp >> 1) | topbit
                vn = vn >> 1
                eq = peq[base + x - 1][chan[:, x - 1 : x - 1 + wf]]
                vp, vn, cc = step(vp, vn, cc, eq, k)
        out[p] = cc <= k
    return out


def scan_folded_dp_ref(
    rows: torch.Tensor,
    pat: torch.Tensor,
    bound: Bound,
    start: int,
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
    plens: Sequence[int],
) -> torch.Tensor:
    """Plain PyTorch version of kernel A, on any device (the clamped band,
    :func:`_band_verdicts`)."""
    plens = tuple(int(m) for m in plens)
    _check_args(rows, pat, bound, k, m_max, wf, halo, plens)
    hits = _band_verdicts(rows, pat, k=k, wf=wf, plens=plens)
    return _reduce(hits, rows, bound, start, None, False, wf)


def scan_folded_myers_ref(
    rows: torch.Tensor,
    pat: torch.Tensor,
    bound: Bound,
    start: int,
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
    plens: Sequence[int],
    alphabet: Sequence[int],
    peq: torch.Tensor = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel C, on any device (the bit-parallel
    band, :func:`_myers_verdicts`)."""
    plens = tuple(int(m) for m in plens)
    _check_args(rows, pat, bound, k, m_max, wf, halo, plens)
    hits = _myers_verdicts(rows, pat, k=k, m_max=m_max, wf=wf, plens=plens,
                           alphabet=alphabet, peq=peq)
    return _reduce(hits, rows, bound, start, None, False, wf)


def _plain_verdicts(rows, pat, bound, *, k, m_max, wf, halo, plens, alphabet,
                    dp_impl, peq):
    """(P, R, wf) bool: every window's ``<= k`` verdict in the mode the
    dispatch chooses (ownership not applied; False for padding patterns)."""
    plens = tuple(int(m) for m in plens)
    _check_args(rows, pat, bound, k, m_max, wf, halo, plens)
    if _is_myers(k, m_max, plens, alphabet, dp_impl):
        return _myers_verdicts(rows, pat, k=k, m_max=m_max, wf=wf, plens=plens,
                               alphabet=alphabet, peq=peq)
    return _band_verdicts(rows, pat, k=k, wf=wf, plens=plens)


def scan_folded_dp_batch_ref(
    rows, pat, meta, *, k, m_max, wf, halo, plens, alphabet=(),
    dp_impl="auto", peq=None,
) -> torch.Tensor:
    """Plain version of the batch mode (:func:`scan_folded_dp_batch`'s
    arguments), on any device, in the mode its dispatch chooses."""
    _check_meta(rows, meta)
    hits = _plain_verdicts(rows, pat, 0, k=k, m_max=m_max, wf=wf, halo=halo,
                           plens=plens, alphabet=alphabet, dp_impl=dp_impl, peq=peq)
    return _reduce(hits, rows, 0, 0, meta, False, wf)


def scan_folded_dp_mask_ref(
    rows, pat, bound, start, *, k, m_max, wf, halo, plens, alphabet=(),
    dp_impl="auto", peq=None,
):
    """Plain version of the mask mode (:func:`scan_folded_dp_mask`'s
    arguments), on any device, in the mode its dispatch chooses."""
    hits = _plain_verdicts(rows, pat, bound, k=k, m_max=m_max, wf=wf, halo=halo,
                           plens=plens, alphabet=alphabet, dp_impl=dp_impl, peq=peq)
    return _reduce(hits, rows, bound, start, None, True, wf)


def scan_folded_ref(
    rows: torch.Tensor,
    pat: torch.Tensor,
    plen: torch.Tensor,
    bound: Bound,
    start: Union[int, torch.Tensor],
    *,
    k: int,
    m_max: int,
    wf: int,
    halo: int,
) -> torch.Tensor:
    """Plain PyTorch version of the dynamic-length count (TPU kernel #9),
    on any device: the lengths are read from ``plen`` (and must lie in
    ``[0, m_max]``), then the clamped band of :func:`_band_verdicts`."""
    _check_dyn(rows, pat, plen, bound, start, k, m_max, wf, halo)
    plens = tuple(int(m) for m in plen.tolist())
    if any(m < 0 or m > m_max for m in plens):
        raise ValueError(f"plen values must lie in [0, {m_max}]: {plens}")
    start = int(start)
    if isinstance(bound, torch.Tensor):
        bound = int(bound)
    return scan_folded_dp_ref(rows, pat, bound, start, k=k, m_max=m_max, wf=wf,
                              halo=halo, plens=plens)
