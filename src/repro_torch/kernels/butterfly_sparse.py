"""Staircase extents and the stripe-skipping kernels.

After degree-descending relabeling, a power-law biadjacency's nonzeros sit
at low column indices, so each row (and each row tile) has a column extent
past which it is all zero.  A wedge tile ``W_ij = A_i B_j^T`` gets nothing
from K-stripes beyond ``min(kmax_a[i], kmax_b[j])``, and the kernels skip
them.  This module holds the extent helpers (``row_extents``,
``batched_row_extents``, ``row_extents_device``, ``tile_extents``,
``column_extents`` and the gathered-row forms ``gathered_tile_extents`` /
``batched_gathered_tile_extents``) and three kernels:

* ``butterfly_update_sparse``  kernel 4 (``csrc/butterfly_sparse.cu``):
  ``out[i] = sum_{j: ids_b[j] != ids_a[i]} s[j] * C((A B^T)[i, j], 2)``
  with the stripe skip, one graph, global ids; kernel 1's count, peel and
  tile bodies (the caller names one, as for kernel 1) with the extents'
  bound;
* ``butterfly_update_sparse_batched``  kernel 5 (same source): the same
  over a (G, ...) stack, local ids, one staircase per group member;
  kernel 2's two bodies (``butterfly.STACK_BODIES``: the peel body by
  default, the f32 tile body as the yardstick);
* ``b2_stack``  kernel 3 (``csrc/b2_stack.cu``):
  ``out[g, x, y] = C((A_g A_g^T)[x, y], 2) * [x != y]`` with the skip, the
  ``fd_update_mode="b2"`` precompute; ``B2_BODIES``: ``"pairs"`` by
  default (int8 ``wgmma`` fed by TMA over each group's tile pairs I <= J,
  both triangles written from one product, the count body's main loop in
  ``csrc/wgmma_s8.cuh``) and ``"tile"``, the f32 FMA tile it replaced.

Each wrapper takes its plain version (beside it) for CPU tensors and
launches its kernel for CUDA tensors, counting the launch in ``LAUNCHES``.
The plain versions of kernels 4 and 5 honour the extents stripe by stripe,
as the Pallas grid does, so they are the same function as the Pallas
kernels for ANY extents, even ones too tight to be exact.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from . import butterfly as _bfly
from ._build import check_launch, ptr, stream_of

__all__ = [
    "LAUNCHES",
    "row_extents",
    "batched_row_extents",
    "row_extents_device",
    "tile_extents",
    "column_extents",
    "gathered_tile_extents",
    "batched_gathered_tile_extents",
    "butterfly_update_sparse",
    "butterfly_update_sparse_plain",
    "butterfly_update_sparse_batched",
    "butterfly_update_sparse_batched_plain",
    "B2_BODIES",
    "b2_scratch_bytes",
    "b2_stack",
    "b2_stack_plain",
]

# launches of each kernel body (plain calls are not counted); kernel 4
# has kernel 1's three bodies, kernel 5 kernel 2's two
LAUNCHES = {"butterfly_update_sparse[count]": 0,
            "butterfly_update_sparse[peel]": 0,
            "butterfly_update_sparse[tile]": 0,
            "butterfly_update_sparse_batched[peel]": 0,
            "butterfly_update_sparse_batched[tile]": 0,
            "b2_stack[pairs]": 0, "b2_stack[tile]": 0}

B2_BODIES = ("pairs", "tile")


def b2_scratch_bytes(g: int, m: int, n_v: int) -> int:
    """Device scratch of kernel 3's pairs body (``b2_scratch_bytes`` of
    ``csrc/b2_stack.cu``): the s8 copy of the (g, m, n_v) stack, each
    group padded as the count body pads its one matrix."""
    return g * _bfly.count_scratch_bytes(m, n_v)


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


def column_extents(a: torch.Tensor, block_rows: int,
                   block_k: int) -> torch.Tensor:
    """kmax[i] = index of the last nonzero k-stripe in row tile i, + 1:
    the tile max of ``row_extents_device`` (reference ``column_extents``,
    here a tensor function on ``a``'s device)."""
    return tile_extents(row_extents_device(a, block_k), block_rows)


def gathered_tile_extents(row_ext, rows, valid, block_rows: int):
    """Tile extents of a gathered row matrix ``B = A[rows]``: per-row
    extents ``row_ext`` (n_rows,) of A read at ``rows`` (n_b,), padding
    rows (``valid`` False, whose gathered content is zeroed) extent 0, then
    the max over each tile of ``block_rows``; returns int32."""
    ext = torch.where(valid.to(torch.bool), row_ext[rows.long()], 0)
    return tile_extents(ext, block_rows).to(torch.int32)


def batched_gathered_tile_extents(row_ext, rows, valid, block_rows: int):
    """Per-group form of ``gathered_tile_extents``: row_ext (G, M), rows
    and valid (G, W) local row ids and padding mask; returns (G, W/block)
    int32, one staircase per group member."""
    ext = torch.where(valid.to(torch.bool),
                      torch.take_along_dim(row_ext, rows.long(), dim=1), 0)
    return tile_extents(ext, block_rows).to(torch.int32)


def _live_wedges(a, b, kmax_a, kmax_b, blocks):
    """W = A B^T over (..., n, n_v) operands, where stripe k of the tile
    pair (i, j) adds only while k < min(kmax_a[i], kmax_b[j]) — the
    Pallas grid's skip, stripe by stripe."""
    bi, bj, bk = blocks
    n_a, n_v = a.shape[-2:]
    n_b = b.shape[-2]
    per_a = kmax_a.repeat_interleave(bi, dim=-1)[..., :n_a]
    per_b = kmax_b.repeat_interleave(bj, dim=-1)[..., :n_b]
    lim = torch.minimum(per_a[..., :, None], per_b[..., None, :])
    w = torch.zeros((*a.shape[:-1], n_b), dtype=a.dtype, device=a.device)
    for k in range(-(-n_v // bk)):
        cols = slice(k * bk, (k + 1) * bk)
        part = a[..., cols] @ b[..., cols].transpose(-1, -2)
        w += torch.where(lim > k, part, 0.0)
    return w


def butterfly_update_sparse_plain(a, b, s, ids_a, ids_b, kmax_a, kmax_b, *,
                                  blocks):
    """Plain version of kernel 4 (materializes the (n_a, n_b) wedge
    matrix, stripe by stripe)."""
    w = _live_wedges(a, b, kmax_a, kmax_b, blocks)
    b2 = w * (w - 1.0) * 0.5
    not_self = ids_a[:, None] != ids_b[None, :]
    return (b2 * not_self * s[None, :]).sum(dim=-1)


def butterfly_update_sparse_batched_plain(a, b, s, ids_a, ids_b, kmax_a,
                                          kmax_b, *, blocks):
    """Plain version of kernel 5."""
    w = _live_wedges(a, b, kmax_a, kmax_b, blocks)
    b2 = w * (w - 1.0) * 0.5
    not_self = ids_a[:, :, None] != ids_b[:, None, :]
    return (b2 * not_self * s[:, None, :]).sum(dim=-1)


def _check_extents(a, b, kmax_a, kmax_b, blocks):
    bi, bj, _bk = blocks
    lead = tuple(a.shape[:-2])
    n_a, n_b = a.shape[-2], b.shape[-2]
    for name, t, shape in (("kmax_a", kmax_a, (*lead, -(-n_a // bi))),
                           ("kmax_b", kmax_b, (*lead, -(-n_b // bj)))):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_sparse(name, a, b, s, ids_a, ids_b, kmax_a, kmax_b, blocks,
                   body="tile"):
    """Kernels 4 and 5: the wedge-update launch with stripe extents."""
    if a.device.type != "cuda":
        raise ValueError(f"no butterfly kernel for device {a.device}")
    _check_extents(a, b, kmax_a, kmax_b, blocks)
    return _bfly._launch(LAUNCHES, name, a, b, s, ids_a, ids_b, kmax_a,
                         kmax_b, blocks, body=body)


def butterfly_update_sparse(a, b, s, ids_a, ids_b, kmax_a, kmax_b, *,
                            blocks, body="peel"):
    """Kernel 4.  a (n_a, n_v) f32 0/1, b (n_b, n_v), s (n_b,) f32,
    ids_a (n_a,) / ids_b (n_b,) int32, kmax_a (ceil(n_a/bi),) and
    kmax_b (ceil(n_b/bj),) int32 stripe extents of ``blocks = (bi, bj,
    bk)`` row tiles; returns out (n_a,) f32.  ``body`` (one of
    ``butterfly.BODIES``) is the body launched on CUDA tensors, as for
    kernel 1; its form is checked on every device."""
    _bfly.check_body(body, a, b, ids_a, ids_b, kmax_a, kmax_b)
    if a.device.type == "cpu":
        return butterfly_update_sparse_plain(a, b, s, ids_a, ids_b, kmax_a,
                                             kmax_b, blocks=blocks)
    return _launch_sparse("butterfly_update_sparse", a, b, s, ids_a, ids_b,
                          kmax_a, kmax_b, blocks, body=body)


def butterfly_update_sparse_batched(a, b, s, ids_a, ids_b, kmax_a, kmax_b,
                                    *, blocks, body="peel"):
    """Kernel 5.  a (G, n_a, n_v), b (G, n_b, n_v), s (G, n_b), local ids
    (G, n_a) / (G, n_b) int32, per-group extents (G, ceil(n_a/bi)) and
    (G, ceil(n_b/bj)) int32; returns (G, n_a) f32.  ``body`` (one of
    ``butterfly.STACK_BODIES``) is the body launched on CUDA tensors; it
    is checked on every device."""
    _bfly.check_stack_body(body)
    if a.device.type == "cpu":
        return butterfly_update_sparse_batched_plain(
            a, b, s, ids_a, ids_b, kmax_a, kmax_b, blocks=blocks)
    return _launch_sparse("butterfly_update_sparse_batched", a, b, s, ids_a,
                          ids_b, kmax_a, kmax_b, blocks, body=body)


def b2_stack_plain(a, kmax_a, kmax_b, *, blocks):
    """Plain version of kernel 3.  It reads every stripe, so it equals the
    kernel for any extents that upper-bound the true ones (the stripes
    the kernel skips are all zero)."""
    w = torch.einsum("gmc,gnc->gmn", a, a)
    b2 = w * (w - 1.0) * 0.5
    eye = torch.eye(a.shape[1], dtype=a.dtype, device=a.device)
    return b2 * (1.0 - eye)[None]


def b2_stack(a, kmax_a, kmax_b, *, blocks, body="pairs"):
    """Kernel 3.  a (G, m, n_v) f32 0/1; kmax_a (G, ceil(m/bi)) and
    kmax_b (G, ceil(m/bj)) int32 stripe extents of ``blocks = (bi, bj,
    bk)`` row tiles; returns (G, m, m) f32.  ``body`` (one of
    ``B2_BODIES``) is the body launched on CUDA tensors; it is checked on
    every device."""
    if body not in B2_BODIES:
        raise ValueError(f"body {body!r}: one of {B2_BODIES}")
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
    if not (g_n and m and n_v):
        # no pair, or no column: every W is 0, C(0, 2) = 0
        return torch.zeros((g_n, m, m), dtype=torch.float32, device=a.device)
    out = torch.empty((g_n, m, m), dtype=torch.float32, device=a.device)
    lib = _build.library("b2_stack")
    key = f"b2_stack[{body}]"
    if body == "pairs":
        n_scratch = b2_scratch_bytes(g_n, m, n_v)
        # the s8 copy of the stack; freed on return, as the count body's
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=a.device)
        check_launch(lib.b2_stack_pairs_f32(
            ptr(a), ptr(kmax_a), ptr(kmax_b), ptr(out), g_n, m, n_v,
            n_ta, n_tb, bi, bj, bk, ptr(scratch), n_scratch, stream_of(a)),
            key)
    else:
        check_launch(lib.b2_stack_f32(
            ptr(a), ptr(kmax_a), ptr(kmax_b), ptr(out), g_n, m, n_v,
            n_ta, n_tb, bi, bj, bk, stream_of(a)), key)
    LAUNCHES[key] += 1
    return out
