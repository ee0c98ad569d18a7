"""The plain reference of tip decomposition: what decides ``correct``.

Plain PyTorch, independent of the program: it builds its own 0/1 matrix
from the edge arrays, its own pairwise butterflies
``B2[x, y] = C(W[x, y], 2)`` with ``W = A A^T`` over side U (diagonal left
out) and its own supports, and peels side U bottom-up (the paper's
Alg. 2) by levels: every alive vertex at the least support ``t`` is peeled
at once with tip number ``t``, and each alive neighbour's support drops by
its butterflies with the peeled set, but not below ``t``.  Peeling the
vertices of one level together gives the sequential peel's numbers, since
within a level every update is clamped at the same ``t``.

Memory follows the wedge pairs, not n_u^2: ``W`` is computed in row blocks
from a float32 ``A`` (exact with TF32 off: sums of 0/1 products below
n_v < 2^24), only over the vertices of degree 2 or more (one of fewer
neighbours shares no butterfly), and only B2's nonzero entries are kept,
row after row.  A level's drop is the sum of the peeled rows' entries,
scattered onto their columns.

``dtype`` is the precision of the butterflies and supports: float64 for
the reference (exact for every support below 2^53), bfloat16 for the
benchmark's control, the step below the program's float32 integer regime.
``pair_butterflies`` is the dense (n_u, n_u) matrix, for tests.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["pair_butterflies", "tip_numbers"]

# rows of the dense B2 computed per block: (block, n_u) of dtype at a time
_BLOCK_ROWS = 4096
# cells of W computed per block by the reference's own product
_BLOCK_CELLS = 2 ** 26


def _matrix(n_u: int, n_v: int, eu, ev, device, dtype) -> torch.Tensor:
    a = torch.zeros((n_u, n_v), dtype=dtype, device=device)
    a[torch.as_tensor(np.asarray(eu, np.int64), device=device),
      torch.as_tensor(np.asarray(ev, np.int64), device=device)] = 1
    return a


def pair_butterflies(n_u: int, n_v: int, eu, ev, *, device="cpu",
                     dtype=torch.float64) -> torch.Tensor:
    """``B2[x, y] = C(|N(x) & N(y)|, 2)`` for x != y over side U, 0 on the
    diagonal, as an (n_u, n_u) tensor of ``dtype`` on ``device``."""
    a = _matrix(n_u, n_v, eu, ev, device, dtype)
    b2 = torch.empty((n_u, n_u), dtype=dtype, device=device)
    for lo in range(0, n_u, _BLOCK_ROWS):
        hi = min(n_u, lo + _BLOCK_ROWS)
        w = a[lo:hi] @ a.T
        b2[lo:hi] = w * (w - 1) / 2
    del a
    b2.fill_diagonal_(0)
    return b2


@contextlib.contextmanager
def _full_float32():
    """float32 products in float32, whatever the process set (no TF32)."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _pairs(n_u: int, n_v: int, eu, ev, device, dtype):
    """B2's nonzero entries row after row: ``starts`` (host int64, n_u + 1),
    where row x's entries lie in ``[starts[x], starts[x + 1])`` of ``col``
    (int32) and ``val`` (``dtype``), and the supports (``dtype``)."""
    if n_v >= 2 ** 24:
        raise ValueError(f"n_v = {n_v}: W is exact in float32 only below "
                         "2^24")
    eu = np.asarray(eu, np.int64)
    ev = np.asarray(ev, np.int64)
    keep = np.flatnonzero(np.bincount(eu, minlength=n_u) >= 2)
    pos = np.full(n_u, -1, np.int64)
    pos[keep] = np.arange(keep.size)
    on = pos[eu] >= 0
    a = _matrix(keep.size, n_v, pos[eu[on]], ev[on], device, torch.float32)
    rows = torch.as_tensor(keep, device=device)
    counts = np.zeros(n_u, np.int64)
    sup = torch.zeros(n_u, dtype=dtype, device=device)
    cols: List[torch.Tensor] = []
    vals: List[torch.Tensor] = []
    step = max(1, _BLOCK_CELLS // max(1, keep.size))
    with _full_float32():
        for lo in range(0, keep.size, step):
            hi = min(keep.size, lo + step)
            w = a[lo:hi] @ a.T
            w.diagonal(lo).zero_()
            r, c = torch.nonzero(w >= 2, as_tuple=True)
            wv = w[r, c].to(dtype)
            del w
            b = wv * (wv - 1) / 2
            sup.index_add_(0, rows[lo + r], b)
            counts[keep[lo:hi]] = torch.bincount(
                r, minlength=hi - lo).cpu().numpy()
            cols.append(rows[c].to(torch.int32))
            vals.append(b)
    del a
    col = torch.cat(cols) if cols else torch.zeros(0, dtype=torch.int32,
                                                   device=device)
    val = torch.cat(vals) if vals else torch.zeros(0, dtype=dtype,
                                                   device=device)
    return np.concatenate([[0], np.cumsum(counts)]), col, val, sup


def tip_numbers(n_u: int, n_v: int, eu, ev, *, device="cpu",
                dtype=torch.float64) -> Tuple[np.ndarray, int, float]:
    """Tip numbers of every side-U vertex (int64 numpy) by the level
    peel, the number of levels peeled and the largest support."""
    starts, col, val, sup = _pairs(n_u, n_v, eu, ev, device, dtype)
    top = float(sup.max().item()) if n_u else 0.0
    theta = np.zeros(n_u)
    levels = 0
    while n_u:
        # a peeled vertex's support is +inf: out of every later minimum
        now = sup.to(torch.float64).cpu().numpy()
        t = float(now.min())
        if t == float("inf"):
            break
        peel = np.flatnonzero(now <= t)
        theta[peel] = t
        sup.masked_fill_(sup <= t, float("inf"))
        peel = peel[starts[peel + 1] > starts[peel]]
        if peel.size:
            sup.index_add_(0, torch.cat([col[starts[x]:starts[x + 1]]
                                         for x in peel]),
                           torch.cat([val[starts[x]:starts[x + 1]]
                                      for x in peel]), alpha=-1)
            sup.clamp_min_(t)
        levels += 1
    return np.round(theta).astype(np.int64), levels, top
