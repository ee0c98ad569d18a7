"""Staircase extents and the pairwise-butterfly stack kernel.

After degree-descending relabeling, a power-law biadjacency's nonzeros sit
at low column indices, so each row (and each row tile) has a column extent
past which it is all zero.  A wedge tile ``W_ij = A_i B_j^T`` gets nothing
from K-stripes beyond ``min(kmax_a[i], kmax_b[j])``, and the kernels skip
them.  This module holds the extent helpers the dense slice needs
(``row_extents``, ``batched_row_extents``, ``row_extents_device``) and the
``b2_stack`` kernel (kernel 3, ``csrc/b2_stack.cu``), which computes

    out[g, x, y] = C((A_g A_g^T)[x, y], 2) * [x != y]

with that stripe skip — the ``fd_update_mode="b2"`` precompute.  The
wrapper takes its plain version for CPU tensors and launches the kernel
for CUDA tensors, counting the launch in ``LAUNCHES``.

The staircase update kernels (``butterfly_update_pallas_sparse`` and its
batched twin) and the gathered-extent helpers arrive with the sparse
slice.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from ._build import check_launch, ptr, stream_of

__all__ = [
    "LAUNCHES",
    "row_extents",
    "batched_row_extents",
    "row_extents_device",
    "tile_extents",
    "b2_stack",
    "b2_stack_plain",
]

LAUNCHES = {"b2_stack": 0}


def row_extents(a: np.ndarray, block_k: int) -> np.ndarray:
    """ext[r] = index of the last k-stripe with any nonzero in row r, + 1
    (0 for an all-zero row).  An upper bound, not a population count:
    interior zero stripes don't reduce the extent and aren't skipped — which
    is what keeps the skip exact without a staircase assumption."""
    n_rows, n_v = a.shape
    n_k = n_v // block_k
    nz = a.reshape(n_rows, n_k, block_k).sum(axis=2) > 0   # (n_rows, n_k)
    any_nz = nz.any(axis=1)
    last = n_k - np.argmax(nz[:, ::-1], axis=1)
    return np.where(any_nz, last, 0).astype(np.int32)


def batched_row_extents(a_stack: np.ndarray, block_k: int) -> np.ndarray:
    """Per-row extents for a (G, M, C) stack: ext[g, r] = last nonzero
    k-stripe of row r in group g, + 1 (host-side, one vectorized pass)."""
    g_n, n_rows, n_v = a_stack.shape
    n_k = n_v // block_k
    nz = a_stack.reshape(g_n, n_rows, n_k, block_k).sum(axis=3) > 0
    any_nz = nz.any(axis=2)
    last = n_k - np.argmax(nz[:, :, ::-1], axis=2)
    return np.where(any_nz, last, 0).astype(np.int32)


def row_extents_device(a: torch.Tensor, block_k: int) -> torch.Tensor:
    """Tensor twin of ``row_extents`` over the last two dims of ``a``
    (any leading batch dims), on ``a``'s device.  A ragged last stripe
    (columns not a multiple of ``block_k``) counts as a stripe."""
    n_v = a.shape[-1]
    n_k = -(-n_v // block_k)
    if n_k * block_k != n_v:
        a = F.pad(a, (0, n_k * block_k - n_v))
    nz = (a.reshape(*a.shape[:-1], n_k, block_k) != 0).any(dim=-1)
    any_nz = nz.any(dim=-1)
    last = n_k - torch.argmax(nz.flip(-1).to(torch.int8), dim=-1)
    return torch.where(any_nz, last, 0).to(torch.int32)


def tile_extents(ext: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Row-tile extents: the max of ``ext`` (..., rows) over each tile of
    ``block_rows`` rows (a ragged last tile is a tile)."""
    rows = ext.shape[-1]
    n_t = -(-rows // block_rows)
    if n_t * block_rows != rows:
        ext = F.pad(ext, (0, n_t * block_rows - rows))
    return ext.reshape(*ext.shape[:-1], n_t, block_rows).amax(dim=-1)


def b2_stack_plain(a, kmax_a, kmax_b, *, blocks):
    """Plain version of kernel 3.  It reads every stripe, so it equals the
    kernel for any extents that upper-bound the true ones (the stripes
    the kernel skips are all zero)."""
    w = torch.einsum("gmc,gnc->gmn", a, a)
    b2 = w * (w - 1.0) * 0.5
    eye = torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    return b2 * (1.0 - eye)[None]


def b2_stack(a, kmax_a, kmax_b, *, blocks):
    """Kernel 3.  a (G, m, n_v) f32 0/1; kmax_a (G, ceil(m/bi)) and
    kmax_b (G, ceil(m/bj)) int32 stripe extents of ``blocks = (bi, bj,
    bk)`` row tiles; returns (G, m, m) f32."""
    if a.device.type == "cpu":
        return b2_stack_plain(a, kmax_a, kmax_b, blocks=blocks)
    if a.device.type != "cuda":
        raise ValueError(f"no b2_stack kernel for device {a.device}")
    bi, bj, bk = (int(x) for x in blocks)
    g_n, m, n_v = a.shape
    n_ta, n_tb = -(-m // bi), -(-m // bj)
    for name, t, dt, shape in (("a", a, torch.float32, (g_n, m, n_v)),
                               ("kmax_a", kmax_a, torch.int32, (g_n, n_ta)),
                               ("kmax_b", kmax_b, torch.int32, (g_n, n_tb))):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((g_n, m, m), dtype=torch.float32, device=a.device)
    if g_n and m:
        lib = _build.library("b2_stack")
        check_launch(lib.b2_stack_f32(
            ptr(a), ptr(kmax_a), ptr(kmax_b), ptr(out), g_n, m, n_v,
            n_ta, n_tb, bi, bj, bk, stream_of(a)), "b2_stack")
        LAUNCHES["b2_stack"] += 1
    return out
