"""Distribution strategies over several devices (port of
``apm/parallel/strategies.py``, its Pallas branches).

* ``database_over_devices`` (the reference's strategy B): the window axis
  is cut into ``n_dev`` shards of ``s`` windows, ``s = max(round_up(
  cdiv(dev_bound, n_dev), w), w)``. Shard ``d`` stages the rows of
  ``fold(buf, d*s, s // wf, wf, halo)`` (its halo included) on its own
  device and owns the window starts ``[d*s, (d+1)*s)`` below the global
  ``dev_bound``: every window start is counted by exactly one shard, and
  the EOF tail once, on the host. A shard wider than ``chunk_bytes`` is
  staged in chunks on its device, each bounded by the shard's end. Each
  chunk runs the kernels of the single-device scan
  (``Scanner._launch_chunk``); the per-pattern counts are fetched once per
  device and summed, apm's ``psum``. At k >= 1 the shards' filtration
  results travel in apm's packed layout (:func:`_collective_pack`) into
  :func:`apm_torch.models.pipeline.finalize_filtration`.
* ``patterns_over_devices`` (strategy A): the patterns are split into
  length-balanced groups (:func:`_pattern_groups`), one sub-Scanner per
  group on its own device, each running the whole single-device scan on
  the replicated corpus from its own thread; one host fold serves every
  group.

``devices`` is a sequence of ``torch.device`` and may repeat a device:
several shards on one card (or on the CPU) run the same code as shards on
several cards. :func:`_count_shards` is shared with
:func:`apm_torch.parallel.multihost.count_multihost`, where the sums and
gathers cross processes. ``apm``'s XLA-engine branches have no
counterpart: both of the port's backends take ``apm``'s Pallas route.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.common import round_up

if TYPE_CHECKING:  # pragma: no cover
    from ..models.pipeline import ScanPlan
    from ..models.scanner import Scanner


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _device_guard(dev: torch.device):
    """Make ``dev`` the current card while kernels are launched on it."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


@dataclass(frozen=True)
class ShardLayout:
    """How a database-sharded scan cuts the window axis: ``n_dev`` shards of
    ``s`` windows, each staged as ``per_shard`` chunks of ``chunk_win``
    windows. A unit is one staged chunk; units are numbered shard-major."""

    n_dev: int
    s: int
    chunk_win: int
    per_shard: int

    @property
    def n_units(self) -> int:
        return self.n_dev * self.per_shard

    def unit(self, u: int) -> Tuple[int, int]:
        """``(shard, c0)`` of unit ``u``."""
        d, i = divmod(u, self.per_shard)
        return d, d * self.s + i * self.chunk_win


def shard_layout(plan: "ScanPlan", n_dev: int, chunk_bytes: int) -> ShardLayout:
    """``apm``'s shard width over ``plan.dev_bound``, and the chunks a shard
    is staged in (one unless the shard is wider than ``chunk_bytes``)."""
    s = max(round_up(_cdiv(plan.dev_bound, n_dev), plan.w), plan.w)
    chunk_win = max(plan.w, round_up(min(chunk_bytes, s), plan.w))
    return ShardLayout(n_dev, s, chunk_win, _cdiv(s, chunk_win))


class LocalComm:
    """The collectives of a scan whose shards all live in this process:
    the "psum" is the host sum of one fetch per device, the "all_gather"
    is the shards in order."""

    world, rank = 1, 0

    def __init__(self, n_dev: int):
        self.shards_per_rank = [n_dev]

    def reduce(self, v: np.ndarray) -> np.ndarray:
        return v

    def gather(self, rows: np.ndarray, per_shard: int) -> np.ndarray:
        return rows


@dataclass
class _Unit:
    """One staged chunk of one shard, on its device."""

    u: int  # global unit index
    c0: int
    bound: int  # exclusive bound of the window starts it owns
    rep: "Scanner"
    drows: torch.Tensor
    rowmap: object = None  # (R, P) device row map at k >= 1


def _fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Small device vectors as int64 NumPy arrays, in order, with one
    device-to-host copy per device."""
    by_dev: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(i)
    out: List[np.ndarray] = [None] * len(tensors)  # type: ignore[list-item]
    for idx in by_dev.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx]).cpu().numpy().astype(np.int64)
        off = 0
        for i in idx:
            size = tensors[i].numel()
            out[i] = flat[off : off + size]
            off += size
    return out


def _collective_pack(packs: Sequence[np.ndarray], p: int, comm, per_shard: int = 1) -> np.ndarray:
    """The shards' packed phase-2 vectors (``[fcnt (P) | vcnt (P) | n_hot
    (1) | clip_starts (MAX_CLIP)]`` each, this process's units in order) as
    ``apm``'s one replicated vector ``[fcnt (P) | vcnt (P) | n_hot (D) |
    clip_starts (D*MAX_CLIP)]``: the totals summed over every unit of every
    process, the hot-row counts and clipped-row starts gathered in global
    unit order."""
    packs = np.stack([np.asarray(pk, dtype=np.int64) for pk in packs])
    totals = comm.reduce(packs[:, : 2 * p].sum(axis=0))
    meta = comm.gather(packs[:, 2 * p :], per_shard)
    return np.concatenate([totals, meta[:, 0], meta[:, 1:].reshape(-1)])


def _unpack_sharded(packed, p: int, n_dev: int):
    """Split a sharded ``packed`` vector: ``(fcnt, vcnt, n_hots (D,),
    clip_starts (D, MAX_CLIP))``."""
    from ..ops.fused import MAX_CLIP

    packed = np.asarray(packed)
    fcnt = packed[:p]
    vcnt = packed[p : 2 * p]
    n_hots = packed[2 * p : 2 * p + n_dev]
    clips = packed[2 * p + n_dev :].reshape(n_dev, MAX_CLIP)
    return fcnt, vcnt, n_hots, clips


def sharded_filter_chunks(
    scanner: "Scanner", plan: "ScanPlan", layout: ShardLayout,
    units: Sequence[_Unit], packed: np.ndarray, comm, *, single_proc: bool,
):
    """``finalize_filtration``'s inputs from a sharded scan (k >= 1), as
    ``apm`` builds them: one :class:`FilterChunk` per unit of every
    process, the summed totals on unit 0 only, no device re-verify (a
    summed ``vcnt`` cannot be split per chunk), and a lazy row-map fetch
    where one process holds every unit (else None: no process can read
    another's). ``rescan()`` runs the banded DP over this process's units,
    each on its own device, and sums over the processes."""
    from ..models.pipeline import FilterChunk

    p_pad = scanner._pat.shape[0]
    fcnt, vcnt, n_hots, clips = _unpack_sharded(packed, p_pad, layout.n_units)
    by_u = {unit.u: unit for unit in units}

    def rowmap_of(unit):
        return lambda: unit.rowmap.cpu().numpy()

    fchunks = [
        FilterChunk(
            layout.unit(u)[1],
            fcnt if u == 0 else None,
            vcnt if u == 0 else None,
            int(n_hots[u]),
            clips[u],
            rowmap_of(by_u[u]) if single_proc else None,
        )
        for u in range(layout.n_units)
    ]

    def rescan() -> np.ndarray:
        parts = []
        for unit in units:
            with _device_guard(unit.drows.device):
                parts.append(unit.rep._scan_dp(
                    unit.drows, unit.bound, unit.c0, plan.plens_filter,
                    wf=plan.wf, halo=plan.halo,
                ))
        local = np.sum(_fetch(parts), axis=0) if parts else np.zeros((p_pad,), np.int64)
        return comm.reduce(local)

    return fchunks, rescan


def _count_shards(
    scanner: "Scanner", plan: "ScanPlan", layout: ShardLayout,
    shards: Sequence[Tuple[int, "Scanner"]], stage, comm, reader, n: int,
    *, single_proc: bool,
) -> np.ndarray:
    """The device-owned counts of a database-sharded scan: ``(p_pad,)``
    int64, the EOF tail excluded. ``shards`` are this process's ``(global
    shard index, scanner on the shard's device)``; ``stage(rep, c0,
    n_rows)`` returns a chunk's staged rows on ``rep``'s device. Every
    unit's kernels are launched first, then the counts come back in one
    fetch per device and are summed across processes by ``comm``."""
    from ..models import pipeline
    from ..ops import fused

    p_pad = scanner._pat.shape[0]
    setups: Dict[int, dict] = {}
    units: List[_Unit] = []
    handles: List[torch.Tensor] = []
    packs: List[torch.Tensor] = []
    for gi, rep in shards:
        st = setups.get(id(rep))
        if st is None:
            st = setups[id(rep)] = rep._count_setup(
                plan, chunk_win=layout.chunk_win, max_hot=fused.MAX_HOT
            )
        bound = min(plan.dev_bound, (gi + 1) * layout.s)
        for i in range(layout.per_shard):
            u = gi * layout.per_shard + i
            c0 = layout.unit(u)[1]
            drows = stage(rep, c0, st["n_rows"])
            with _device_guard(drows.device):
                got, raw = rep._launch_chunk(st, drows, c0, bound=bound)
            handles += got
            unit = _Unit(u, c0, bound, rep, drows)
            if raw is not None:
                packs.append(raw[1])
                unit.rowmap = raw[2]
            units.append(unit)

    fetched = _fetch(handles + packs)
    local = np.zeros((p_pad,), dtype=np.int64)
    for v in fetched[: len(handles)]:
        local += v
    counts = comm.reduce(local)
    if packs:
        packed = _collective_pack(fetched[len(handles) :], p_pad, comm, layout.per_shard)
        fchunks, rescan = sharded_filter_chunks(
            scanner, plan, layout, units, packed, comm, single_proc=single_proc
        )
        counts = counts + pipeline.finalize_filtration(
            scanner, reader, plan, n, fchunks, rescan, max_hot=fused.MAX_HOT
        )
    return counts


def count_database_over_devices(
    scanner: "Scanner", buf: np.ndarray, devices: Sequence[torch.device]
) -> np.ndarray:
    """Shard the window axis over ``devices`` (module doc). Returns
    ``(p_pad,)`` int64 counts per scan pattern slot, EOF tail included.
    Each shard's rows go through its device's replica Scanner
    (``Scanner._replicas``) and its device corpus cache."""
    from ..models.pipeline import buf_reader, make_plan
    from ..models.scanner import _concrete

    devices = [_concrete(d) for d in devices]
    n = len(buf)
    plan = make_plan(scanner, n)
    scanner.last_filtration = None
    counts = np.zeros((scanner._pat.shape[0],), dtype=np.int64)
    if plan.dev_bound > 0:
        layout = shard_layout(plan, len(devices), scanner.config.chunk_bytes)
        reps = scanner._replicas(devices)
        fp = scanner._corpus_fp(buf)

        def stage(rep, c0, n_rows):
            return rep._staged_rows(buf, fp, c0, n_rows, plan.wf, plan.halo)

        counts += _count_shards(
            scanner, plan, layout, [(d, reps[dev]) for d, dev in enumerate(devices)],
            stage, LocalComm(len(devices)), buf_reader(buf), n, single_proc=True,
        )
    counts[: scanner.scan_patterns.num_patterns] += scanner.tail_counts(buf, plan.dev_bound)
    return counts


def _pattern_groups(scanner: "Scanner", n_dev: int) -> List[List[int]]:
    """Length-balanced pattern assignment: greedy least-loaded binning by
    pattern length (a pattern's scan cost is about linear in m for the
    banded and the filtration kernels)."""
    p = scanner.scan_patterns.num_patterns
    n_use = max(1, min(n_dev, p))
    order = sorted(range(p), key=lambda i: -len(scanner.scan_patterns.raw[i]))
    groups: List[List[int]] = [[] for _ in range(n_use)]
    loads = [0] * n_use
    for i in order:
        d = loads.index(min(loads))
        groups[d].append(i)
        loads[d] += max(len(scanner.scan_patterns.raw[i]), 1)
    return [sorted(g) for g in groups]


def count_patterns_over_devices(
    scanner: "Scanner", buf: np.ndarray, devices: Sequence[torch.device]
) -> np.ndarray:
    """Shard the pattern axis over ``devices``; the corpus is replicated.
    Group ``d`` (:func:`_pattern_groups`) runs the whole single-device scan
    (``Scanner._count_device``) on ``devices[d]`` from its own thread, at
    one pinned block width so one host fold serves every group (the shared
    fold is dropped when the call returns); the counts are scattered back
    by group."""
    from ..models.scanner import _concrete

    devices = [_concrete(d) for d in devices]
    n = len(buf)
    groups = _pattern_groups(scanner, len(devices))
    subs = scanner._pattern_shard_scanners(
        groups, devices[: len(groups)], block_windows=scanner.block_windows_for(n)
    )
    fp = scanner._corpus_fp(buf)
    scanner.last_filtration = None

    def run(d: int) -> np.ndarray:
        with _device_guard(subs[d].device):
            return subs[d]._count_device(buf, n, fp=fp)

    try:
        if len(groups) == 1:
            outs = [run(0)]
        else:
            with ThreadPoolExecutor(len(groups)) as ex:
                outs = list(ex.map(run, range(len(groups))))
    finally:
        # the shared fold serves this call's groups only (a repeated call
        # hits the groups' device caches): release its page-locked rows
        subs[0]._fold_cache.clear()
    counts = np.zeros((scanner._pat.shape[0],), dtype=np.int64)
    for d, g in enumerate(groups):
        for slot, pi in enumerate(g):
            counts[pi] = outs[d][slot]
    return counts


def count_distributed(
    scanner: "Scanner", buf: np.ndarray, strategy: str, devices: Sequence[torch.device]
) -> np.ndarray:
    """Counts of ``buf`` under ``strategy`` over ``devices``: ``(p_pad,)``
    int64 per scan pattern slot, EOF tail included."""
    if strategy == "database_over_devices":
        return count_database_over_devices(scanner, buf, devices)
    if strategy == "patterns_over_devices":
        return count_patterns_over_devices(scanner, buf, devices)
    raise ValueError(f"unknown distribution strategy {strategy!r}")
