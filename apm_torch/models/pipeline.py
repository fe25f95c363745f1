"""Scan planning (port of ``apm/models/pipeline.py::ScanPlan``/``make_plan``).

One place computes every derived layout quantity of a scan — block width,
staging-row width and halo, the device-owned window bound, and the engine
gating — exactly as ``apm``'s ``make_plan(scanner, n, "pallas")`` does, so
both packages stage byte-identical rows and route the same patterns.
``ScanPlan`` keeps ``apm``'s fields; which kernel serves each group of
patterns in the port is decided in :class:`apm_torch.models.scanner.Scanner`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

from ..ops.common import round_up

if TYPE_CHECKING:  # pragma: no cover
    from .scanner import Scanner

# apm's DP fold for int32 cells (rows per Pallas block); the block width is
# rounded to fold x 128 windows, as in apm.
_FOLD = 8


@dataclass(frozen=True)
class ScanPlan:
    """Derived layout for one scan: the quantities every path must agree on."""

    backend: str
    fold: int  # apm's DP sublane fold (block windows = fold * wf)
    w: int  # block windows (rounded to the fold x lane tile)
    wf: int  # windows per staging row
    halo: int  # staging-row overlap >= m_max + 2k, lane-aligned
    dev_bound: int  # exclusive bound of device-owned window starts
    engine: str  # "auto"/"filter"/"dp"/"corr" after fold gating
    fmask: tuple  # per-pattern: True when filtration-eligible
    plens_filter: tuple  # static lengths apm routes to the filtration kernel
    plens_dp: tuple  # static lengths routed to the banded DP kernel
    use_corr: bool = False  # k = 0 correlation engine takes the scan
    plens_corr: tuple = ()  # static lengths routed to the corr engine
    fp1_conv: bool = False  # k >= 1: apm runs filtration phase 1 as a conv

    @property
    def any_filter(self) -> bool:
        return any(self.plens_filter)

    @property
    def any_dp(self) -> bool:
        return any(self.plens_dp)


def check_dp_dtype(dp_dtype: str) -> None:
    """The port's DP cells are int32. ``apm``'s int16/int8 cells are
    interpreter-only test layouts on its side and have no kernel here."""
    if dp_dtype != "int32":
        raise NotImplementedError(
            f"dp_dtype={dp_dtype!r} is not ported; apm_torch computes int32 "
            "cells (see ROADMAP.md, Queue 2)"
        )


def make_plan(scanner: "Scanner", n: int) -> ScanPlan:
    """Compute the scan layout (``apm``'s device-path plan).

    The halo satisfies every kernel's lookahead: the banded kernel needs
    ``halo >= m_max - 1 + k`` bytes, apm's filtration kernel
    ``halo >= m_max + 2k`` — so ``round_up(m_max + 2k, 128)`` everywhere.
    """
    from ..ops.corr_engine import (
        ALPHABET_MAX,
        M_MAX_CORR,
        corr_eligible,
        fp1_conv_eligible,
    )
    from ..ops.filter_kernel import FOLD as FILTER_FOLD, partition_plens

    check_dp_dtype(scanner.config.dp_dtype)
    k = scanner.k
    fold = _FOLD
    w = round_up(scanner.block_windows_for(n), max(fold, FILTER_FOLD) * 128)
    halo = round_up(scanner.m_max + 2 * k, 128)
    engine = scanner.config.engine
    plens = scanner._plens_static
    alphabet_size = len(scanner._corr_alphabet())

    use_corr = False
    if k == 0 and engine in ("auto", "corr"):
        use_corr = corr_eligible(
            plens, alphabet_size, scanner.m_max, k, auto=engine == "auto"
        )
    if engine == "corr" and not use_corr:
        raise ValueError(
            "engine='corr' requires k == 0, a pattern alphabet of <= "
            f"{ALPHABET_MAX} distinct bytes, and m_max <= {M_MAX_CORR}"
        )
    if use_corr:
        zeros = tuple(0 for _ in plens)
        return ScanPlan(
            backend=scanner.backend,
            fold=fold,
            w=w,
            wf=w // fold,
            halo=halo,
            dev_bound=scanner.device_window_bound(n),
            engine="corr",
            fmask=tuple(False for _ in plens),
            plens_filter=zeros,
            plens_dp=zeros,
            use_corr=True,
            plens_corr=plens,
        )

    fmask, plens_filter, plens_dp = partition_plens(plens, k, engine)
    fp1_conv = False
    if engine == "auto" and any(plens_filter):
        fp1_conv = fp1_conv_eligible(plens_filter, k, alphabet_size)

    return ScanPlan(
        backend=scanner.backend,
        fold=fold,
        w=w,
        wf=w // fold,
        halo=halo,
        dev_bound=scanner.device_window_bound(n),
        engine=engine,
        fmask=fmask,
        plens_filter=plens_filter,
        plens_dp=plens_dp,
        fp1_conv=fp1_conv,
    )
