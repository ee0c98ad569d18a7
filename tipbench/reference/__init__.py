"""The plain reference of tip decomposition: what decides ``correct``.

Plain PyTorch, independent of the program: it builds its own 0/1 matrix
from the edge arrays, its own pairwise butterfly matrix
``B2 = C(A A^T, 2)`` (diagonal zeroed) and its own supports, and peels
side U bottom-up (the paper's Alg. 2) by levels: every alive vertex at
the least support ``t`` is peeled at once with tip number ``t``, and each
alive neighbour's support drops by its butterflies with the peeled set,
but not below ``t``.  Peeling the vertices of one level together gives the
sequential peel's numbers, since within a level every update is clamped
at the same ``t``.

``dtype`` is the precision of the matrices and supports: float64 for the
reference (exact for every support below 2^53), bfloat16 for the
benchmark's control, the step below the program's float32 integer regime.
Rows of the matrices are built in blocks so that a large graph fits.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["pair_butterflies", "tip_numbers"]

# rows of B2 computed per block: (block, n_u) of dtype at a time
_BLOCK_ROWS = 4096


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


def tip_numbers(n_u: int, n_v: int, eu, ev, *, device="cpu",
                dtype=torch.float64) -> Tuple[np.ndarray, int, float]:
    """Tip numbers of every side-U vertex (int64 numpy) by the level
    peel, the number of levels peeled and the largest support."""
    b2 = pair_butterflies(n_u, n_v, eu, ev, device=device, dtype=dtype)
    sup = b2.sum(dim=1)
    top = float(sup.max().item()) if n_u else 0.0
    theta = torch.zeros(n_u, dtype=torch.float64, device=device)
    alive = torch.ones(n_u, dtype=torch.bool, device=device)
    inf = torch.tensor(float("inf"), dtype=dtype, device=device)
    levels = 0
    left = n_u
    while left:
        t = torch.where(alive, sup, inf).min()
        peel = alive & (sup <= t)
        rows = torch.nonzero(peel).squeeze(1)
        theta[rows] = t.to(torch.float64)
        alive[rows] = False
        left -= rows.numel()
        drop = b2.index_select(0, rows).sum(dim=0)
        sup = torch.where(alive, torch.maximum(sup - drop, t), sup)
        levels += 1
    return theta.round().to(torch.int64).cpu().numpy(), levels, top
