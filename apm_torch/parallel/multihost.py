"""The scan of one corpus file across processes (port of
``apm/parallel/multihost.py``) on ``torch.distributed``.

* :func:`initialize` bootstraps the process group (the reference's
  ``MPI_Init``): ``nccl`` where each process has a card of its own,
  ``gloo`` on the CPU or where processes share a card (NCCL refuses two
  ranks on one GPU). A failed bootstrap raises.
* :func:`count_multihost`: every process stages only the rows of its own
  shards, straight from the file (``native.read_folded``: no process reads
  the whole corpus), and runs the database strategy's shard scan
  (:func:`apm_torch.parallel.strategies._count_shards`). The global shard
  index is the process's first shard plus the local index, the processes'
  shard counts gathered first. The per-pattern totals go through
  ``all_reduce`` and the shards' hot-row counts and clipped-row starts
  through ``all_gather``, so every process holds the same packed vector
  and takes the same branch of ``finalize_filtration``; the banded rescan
  is collective too. Past one process no row map can be fetched (a
  process cannot read another's shards), so an overflowed bucket is
  recovered by the rescan. The EOF tail is read and counted identically
  on every process; every process returns the same counts.

Each process scans on :func:`local_devices`: its own card under ``nccl``,
``scanner.devices()`` under ``gloo``. Without an initialized group the
scan runs as a one-process world over ``scanner.devices()``.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import TYPE_CHECKING, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .strategies import LocalComm, _count_shards, shard_layout

if TYPE_CHECKING:  # pragma: no cover
    from ..models.scanner import Scanner


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: float = 300.0,
) -> None:
    """Join (or form) the process group.

    ``coordinator_address`` is ``host:port`` of process 0's store (else the
    ``MASTER_ADDR``/``MASTER_PORT`` environment, ``env://``);
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``. ``backend`` defaults to ``nccl`` when this host has a card
    for every process (process ``i`` takes card ``i``), else ``gloo``.
    ``timeout`` (seconds) bounds the bootstrap and every collective. A
    no-op when a group is already initialized; any other failure raises.
    """
    if dist.is_initialized():
        return
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if backend is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = "nccl" if 0 < world <= cards else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        world_size=world,
        rank=rank,
        timeout=timedelta(seconds=timeout),
    )


def shutdown() -> None:
    """Leave the process group, if one is initialized."""
    if dist.is_initialized():
        dist.destroy_process_group()


class DistComm:
    """The collectives of :func:`count_multihost` over the process group:
    int64 vectors on the backend's device (the current card under
    ``nccl``, the CPU under ``gloo``)."""

    def __init__(self, n_local: int):
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        self.dev = (
            torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl"
            else torch.device("cpu")
        )
        t = torch.tensor([n_local], dtype=torch.int64, device=self.dev)
        got = [torch.zeros_like(t) for _ in range(self.world)]
        dist.all_gather(got, t)
        self.shards_per_rank = [int(g.item()) for g in got]

    def reduce(self, v: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int64)).to(self.dev)
        dist.all_reduce(t)
        return t.cpu().numpy()

    def gather(self, rows: np.ndarray, per_shard: int) -> np.ndarray:
        """``(units here, c)`` rows of every process, in rank order."""
        counts = [c * per_shard for c in self.shards_per_rank]
        t = torch.zeros((max(counts), rows.shape[1]), dtype=torch.int64, device=self.dev)
        t[: len(rows)] = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
        got = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(got, t)
        return np.concatenate([g[:c].cpu().numpy() for g, c in zip(got, counts)])


def local_devices(scanner: "Scanner") -> List[torch.device]:
    """The devices this process stages its shards on. Under ``nccl`` each
    process has a card of its own (:func:`initialize`), so only that card;
    under ``gloo``, or without a group, ``scanner.devices()`` (logical CPU
    devices, or the cards the processes share)."""
    from ..models.scanner import _concrete

    if dist.is_initialized() and dist.get_backend() == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [_concrete(d) for d in scanner.devices()]


def count_multihost(scanner: "Scanner", path) -> np.ndarray:
    """Counts of the corpus file ``path`` over this process's
    :func:`local_devices` and those of every other process of the group
    (module doc). Returns ``(p_pad,)`` int64 counts per scan pattern slot,
    the same on every process."""
    from ..models.pipeline import file_reader, make_plan
    from ..utils import native

    path = os.fspath(path)
    n = os.path.getsize(path)
    plan = make_plan(scanner, n)
    devices = local_devices(scanner)
    comm = DistComm(len(devices)) if dist.is_initialized() else LocalComm(len(devices))
    first = sum(comm.shards_per_rank[: comm.rank])
    scanner.last_filtration = None
    counts = np.zeros((scanner._pat.shape[0],), dtype=np.int64)
    if plan.dev_bound > 0:
        layout = shard_layout(plan, sum(comm.shards_per_rank), scanner.config.chunk_bytes)
        reps = scanner._replicas(devices)
        wf, halo = plan.wf, plan.halo

        def stage(rep, c0, n_rows):
            host = rep._host_rows(n_rows, wf + halo)
            native.read_folded(path, c0, n_rows, wf, halo, out=host.numpy())
            return rep._to_device(host)

        counts += _count_shards(
            scanner, plan, layout,
            [(first + i, reps[dev]) for i, dev in enumerate(devices)],
            stage, comm, file_reader(path), n, single_proc=comm.world == 1,
        )
    counts[: scanner.scan_patterns.num_patterns] += _read_tail(path, plan.dev_bound, n, scanner)
    return counts


def _read_tail(path: str, dev_bound: int, n: int, scanner: "Scanner") -> np.ndarray:
    """The EOF tail windows ``[dev_bound, n - k)``, read from the file and
    counted by the native verifier (``Scanner.suffix_counts``)."""
    from ..utils import native

    if dev_bound >= max(n - scanner.k, 0):
        return np.zeros((scanner.scan_patterns.num_patterns,), dtype=np.int64)
    return scanner.suffix_counts(native.read_range(path, dev_bound, n - dev_bound))
