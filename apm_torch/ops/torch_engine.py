"""Reference scan engine in plain PyTorch (port of ``apm/ops/xla_engine.py``).

The clamped banded Levenshtein scan as a loop over DP steps, with the whole
``(patterns, windows)`` batch of a block advanced in lockstep as tensor
operations. Unlike the kernels' staged-row contract it counts the whole
corpus, EOF-truncated windows included: window starts ``j in [0, n - k)``,
per-window length ``size = min(m, n - j)``, a match iff the banded distance
``D[size][size]`` (cells clamped at ``cap_for(k)``) is ``<= k`` — the
semantics of ``apm.utils.oracle`` and of the C reference. It is the port's
second oracle and the CPU branch of :func:`apm_torch.graft_entry.entry`.
It runs on any device; it has no kernel of its own.
"""

from __future__ import annotations

from typing import Union

import torch

from .common import cap_for

Scalar = Union[int, torch.Tensor]


def scan_block_torch(
    text: torch.Tensor,
    pat: torch.Tensor,
    plen: torch.Tensor,
    start: Scalar,
    n: Scalar,
    *,
    k: int,
    m_max: int,
) -> torch.Tensor:
    """``(P,)`` int32 match counts over the ``V = len(text) - m_max`` window
    starts of this block (``apm``'s ``scan_block_xla``).

    ``text`` holds the block's ``V`` windows plus ``m_max`` halo bytes,
    zero-padded past EOF; ``pat`` is the k-padded table ``(P, m_max + 2k)``;
    ``plen`` the lengths (0 = padding row); ``start`` the absolute window
    index of ``text[0]``; ``n`` the corpus length. ``start`` and ``n`` may
    be ints or 0-d tensors: nothing is read back to the host.
    """
    dev = text.device
    v = text.shape[0] - m_max
    p = pat.shape[0]
    cap = cap_for(k)
    bw = 2 * k + 1
    n = torch.as_tensor(n, device=dev).to(torch.int64)
    abs_w = torch.as_tensor(start, device=dev).to(torch.int64) + torch.arange(
        v, device=dev, dtype=torch.int64
    )[None, :]  # (1, V) absolute window starts
    sizes = torch.minimum(plen.to(torch.int64)[:, None], n - abs_w)  # (P, V)
    valid = abs_w < torch.clamp(n - k, min=0)  # (1, V)
    pat32 = pat.to(torch.int32)

    # band[k + d] = D[x][x + d] clamped at cap; row x = 0: D[0][y] = y.
    band = [
        torch.full((p, v), d if d >= 0 else cap, dtype=torch.int32, device=dev)
        for d in range(-k, k + 1)
    ]
    res = torch.full((p, v), cap, dtype=torch.int32, device=dev)
    for x in range(1, m_max + 1):
        tx = text[x - 1 : x - 1 + v].to(torch.int32)[None, :]  # (1, V)
        px = pat32[:, x - 1 : x - 1 + bw]  # (P, 2k + 1): columns d = -k..k
        new = []
        prev = torch.full((p, v), cap, dtype=torch.int32, device=dev)
        for di in range(bw):
            d = di - k
            sub = band[di] + (px[:, di : di + 1] != tx).to(torch.int32)
            dele = band[di + 1] + 1 if d < k else torch.full_like(sub, cap + 1)
            val = torch.minimum(torch.minimum(sub, dele), prev + 1)
            if x + d == 0:  # boundary column D[x][0] = x
                val = torch.full_like(val, x)
            val = torch.clamp(val, max=cap)
            new.append(val)
            prev = val
        band = new
        res = torch.where(sizes == x, band[k], res)  # capture D[size][size]
    matches = (res <= k) & valid
    return matches.sum(dim=1, dtype=torch.int32)


def scan_corpus_torch(
    corpus: torch.Tensor,
    pat: torch.Tensor,
    plen: torch.Tensor,
    n: Scalar,
    start: Scalar = 0,
    *,
    k: int,
    m_max: int,
    v: int,
) -> torch.Tensor:
    """Whole-corpus scan, block by block of ``v`` windows (``apm``'s
    ``scan_corpus_xla``): ``corpus`` is zero-padded to ``n_pad + m_max``
    bytes with ``v | n_pad`` (:func:`apm_torch.ops.common.pad_corpus`).
    Returns ``(P,)`` int32 counts."""
    n_pad = corpus.shape[0] - m_max
    if n_pad % v:
        raise ValueError(f"corpus must be padded to a multiple of the block width {v}")
    start = torch.as_tensor(start, device=corpus.device).to(torch.int64)
    acc = torch.zeros((pat.shape[0],), dtype=torch.int32, device=corpus.device)
    for i in range(n_pad // v):
        blk = corpus[i * v : i * v + v + m_max]
        acc += scan_block_torch(blk, pat, plen, start + i * v, n, k=k, m_max=m_max)
    return acc
