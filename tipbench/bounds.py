"""The least time a hand-kernel launch needs on one H100: frozen copies of
the port's bound arithmetic (``chip_smoke.py``: ``bound``,
``peel_live_work``, ``count_pair_ops``, ``stack_peel_live_work``,
``b2_pair_ops``, ``tiled_peel_live_work``) with the benchmark's own
peaks, and ``launch_bound``, which applies them to the arguments of one
call of a ``repro_torch.kernels.ops`` entry point.

Each count is of what the inputs need, whatever implements it: pairs of
rows that hold a nonzero and carry mass, columns some such row holds,
inputs read once and outputs written once.  The bound of a launch is the
larger of its int8 operations over the int8 peak and its bytes over the
HBM bandwidth.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["INT8_OPS_PER_S", "HBM_BYTES_PER_S", "bound", "peel_live_work",
           "count_pair_ops", "stack_peel_live_work", "b2_pair_ops",
           "tiled_peel_live_work", "tile_extents_of", "launch_bound"]

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
DEFAULT_BLOCKS = (128, 128, 512)


def bound(ops: float, nbytes: float):
    """Least time (ms) the card needs for ``ops`` int8 tensor-core
    operations and ``nbytes`` of HBM traffic, and which one binds."""
    t_ops = ops / INT8_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def peel_live_work(a, b, s, kmax_a=None, kmax_b=None, blocks=None):
    """Operations and bytes the gathered peel form of kernels 1 and 4
    needs: W[i, j] is needed only for gathered rows j with s[j] != 0
    ("valid"), and only over the live columns, where some valid row holds
    a nonzero.  With extents, column c of the pair (i, j) counts only
    below min(kmax_a[i / bi], kmax_b[j / bj]) * bk.  Operations: 2 per (A
    row, valid row, live column below the pair's bound); bytes: A's live
    columns below the farthest bound of each A row tile, read once in
    f32, the valid rows of B once, s, the valid rows' ids, A's ids and
    out (and the extents).  Returns (operations, bytes, live columns)."""
    n_a, n_v = a.shape
    n_b = b.shape[0]
    valid = s != 0
    vrows = torch.nonzero(valid).squeeze(1)
    live = (b[vrows] != 0).any(dim=0)
    cum = torch.zeros(n_v + 1, dtype=torch.float64, device=a.device)
    cum[1:] = torch.cumsum(live.double(), dim=0)
    n_live = float(cum[-1])
    if kmax_a is None:
        ops = 2.0 * n_a * len(vrows) * n_live
        a_cols = n_a * n_live
        ext_bytes = 0.0
    else:
        bi, bj, bk = blocks
        lim = (torch.minimum(kmax_a.long()[:, None],
                             kmax_b.long()[vrows // bj][None, :]) * bk
               ).clamp(max=n_v)                      # (A row tiles, valid)
        tiles = torch.arange(kmax_a.numel(), device=a.device)
        rows = (n_a - tiles * bi).clamp(max=bi).double()
        ops = 2.0 * float((rows[:, None] * cum[lim]).sum())
        reach = (lim.amax(dim=1) if len(vrows)
                 else torch.zeros_like(tiles))
        a_cols = float((rows * cum[reach]).sum())
        ext_bytes = 4.0 * (kmax_a.numel() + kmax_b.numel())
    n_valid = len(vrows)
    nbytes = (4.0 * (a_cols + n_valid * n_v + n_b + n_valid + 2 * n_a)
              + ext_bytes)
    return ops, nbytes, n_live


def count_pair_ops(a, s, kmax=None, blocks=None):
    """Operations the counting form of kernels 1 and 4 (B = A) needs:
    W = A A^T is symmetric, so each pair {i, j} of distinct rows is
    needed once, and only when both rows hold a nonzero and s[i] or s[j]
    is nonzero; 2 operations per live column of the pair (the columns
    where some row with mass holds a nonzero), over every column, or with
    the shared extents only below min(kmax[i / bi], kmax[j / bi]) * bk."""
    n, n_v = a.shape
    held = a != 0
    full = held.any(dim=1)                       # rows holding a nonzero
    mass = full & (s != 0)
    live = held[mass].any(dim=0)
    cum = torch.zeros(n_v + 1, dtype=torch.float64, device=a.device)
    cum[1:] = torch.cumsum(live.double(), dim=0)
    if kmax is None:
        bi = max(n, 1)
        cols = torch.full((1,), n_v, dtype=torch.long, device=a.device)
    else:
        bi, _, bk = blocks
        cols = (kmax.long() * bk).clamp(max=n_v)
    n_t = -(-n // bi)

    def per_tile(v):
        v = torch.nn.functional.pad(v.double(), (0, n_t * bi - n))
        return v.reshape(n_t, bi).sum(dim=1)

    rows, heavy = per_tile(full), per_tile(mass)
    idle = rows - heavy
    pairs = rows[:, None] * rows[None, :] - idle[:, None] * idle[None, :]
    pairs.diagonal().sub_(heavy)              # (i, i) with s[i] != 0
    lim = cum[torch.minimum(cols[:, None], cols[None, :])]
    return float((pairs * lim).sum())


def stack_peel_live_work(a, b, s, kmax_a=None, kmax_b=None, blocks=None):
    """Operations and bytes the stack form of kernels 2 and 5 needs: the
    sum over the groups of what ``peel_live_work`` counts for each
    group's own operands and extents.  Returns (operations, bytes)."""
    ops = nbytes = 0.0
    for g in range(a.shape[0]):
        ext = () if kmax_a is None else (kmax_a[g], kmax_b[g], blocks)
        o, n, _ = peel_live_work(a[g], b[g], s[g], *ext)
        ops += o
        nbytes += n
    return ops, nbytes


def b2_pair_ops(a, kmax_a=None, kmax_b=None, blocks=None):
    """Operations kernel 3 needs: out[g] = C(W_g, 2) with W_g = A_g A_g^T
    symmetric, so each pair {x, y} of distinct rows of a group holding a
    nonzero is needed once; 2 operations per live column of the pair (a
    column some row of the group holds), below min(lim_x, lim_y), where
    lim_x is row x's tighter extent min(kmax_a[x / bi], kmax_b[x / bj]) *
    bk (every column without extents)."""
    g_n, m, n_v = a.shape
    held = a != 0
    full = held.any(dim=2)                                 # (G, m)
    cum = torch.zeros((g_n, n_v + 1), dtype=torch.float64, device=a.device)
    cum[:, 1:] = torch.cumsum(held.any(dim=1).double(), dim=1)
    if kmax_a is None:
        lim = torch.full((g_n, m), n_v, dtype=torch.long, device=a.device)
    else:
        bi, bj, bk = blocks
        per_a = kmax_a.long().repeat_interleave(bi, dim=1)[:, :m]
        per_b = kmax_b.long().repeat_interleave(bj, dim=1)[:, :m]
        lim = (torch.minimum(per_a, per_b) * bk).clamp(max=n_v)
    ops = 0.0
    upper = torch.ones(m, m, dtype=torch.bool, device=a.device).triu(1)
    for g in range(g_n):
        pair = torch.minimum(lim[g][:, None], lim[g][None, :])
        need = upper & full[g][:, None] & full[g][None, :]
        ops += 2.0 * float(cum[g][pair][need].sum())
    return ops


def tiled_peel_live_work(td, scol, pos, live, s):
    """Operations and bytes kernel 6's mask form needs for a peel mask s:
    row y with mass meets the other rows only in its own live partner
    tiles pos[band(y), c], there only at the columns where y holds a
    nonzero; each such column costs 2 bi operations for every live slot
    of column band c.  Bytes: those columns of the live slots of each
    column band, read once in f32, s, out and the index arrays.  Returns
    (operations, bytes)."""
    n_slots, bi, bk = td.shape
    n_rt, n_ct = pos.shape
    ys = torch.nonzero(s).squeeze(1)
    p = pos.long()[ys // bi]                              # (n_y, n_ct)
    ok = (p >= 0) & (live[p.clamp(min=0)] != 0)
    nz = (td[p.clamp(min=0), (ys % bi)[:, None]] != 0) & ok[:, :, None]
    col_live = torch.zeros(n_ct, dtype=torch.float64, device=td.device)
    col_live.index_add_(0, scol.long(), (live != 0).double())
    ops = 2.0 * bi * float((nz.sum(dim=2).double() * col_live).sum())
    cols = nz.any(dim=0).sum(dim=1).double()                # (n_ct,)
    nbytes = (4.0 * bi * float((cols * col_live).sum()) + 4.0 * 2 * n_rt * bi
              + 4.0 * (3 * n_slots + n_rt + 1 + n_rt * n_ct))
    return ops, nbytes


def tile_extents_of(a, block_rows: int, block_k: int):
    """Row-tile stripe extents of ``a`` (..., rows, cols): for each tile of
    ``block_rows`` rows, the index of the last ``block_k``-column stripe
    in which one of its rows holds a nonzero, + 1 (0 for an all-zero
    tile)."""
    *lead, rows, n_v = a.shape
    n_k = -(-n_v // block_k)
    n_t = -(-rows // block_rows)
    pad = torch.nn.functional.pad(
        (a != 0).to(torch.int8), (0, n_k * block_k - n_v,
                                  0, n_t * block_rows - rows))
    nz = pad.reshape(*lead, n_t, block_rows, n_k, block_k).amax(dim=(-3, -1))
    last = n_k - torch.argmax(nz.flip(-1), dim=-1)
    return torch.where(nz.any(dim=-1), last, 0)


def _live_stripe_bytes(kmax_a, kmax_b, n_a, n_b, n_v, blocks, same=False):
    """f32 bytes of the operands' live stripes, each read once: row tile
    i of A up to min(kmax_a[i], max_j kmax_b[j]) stripes, row tile j of B
    likewise; with ``same`` (B is A) the operand counts once, each tile
    to the farther of its two reaches (``chip_smoke.py``'s
    ``live_stripe_bytes``)."""
    bi, bj, bk = blocks
    n_k = -(-n_v // bk)
    ka = kmax_a.long().clamp(max=n_k)
    kb = kmax_b.long().clamp(max=n_k)
    reach_a = torch.minimum(ka, kb.amax(dim=-1, keepdim=True))
    reach_b = torch.minimum(kb, ka.amax(dim=-1, keepdim=True))

    def tile_bytes(reach, n_rows, block):
        tiles = torch.arange(reach.shape[-1], device=reach.device)
        rows = (n_rows - tiles * block).clamp(max=block)
        return 4.0 * float((rows * (reach * bk).clamp(max=n_v)).sum())

    if same:
        return tile_bytes(torch.maximum(reach_a, reach_b), n_a, bi)
    return tile_bytes(reach_a, n_a, bi) + tile_bytes(reach_b, n_b, bj)


def _sparse(backend) -> bool:
    return backend in ("cuda_sparse", "torch_sparse")


def launch_bound(entry: str, args: tuple, kwargs: dict
                 ) -> Optional[Tuple[float, str]]:
    """(bound ms, what binds) of one call of the ``repro_torch.kernels.
    ops`` entry point ``entry`` with these arguments, or None for an entry
    without a hand kernel.  Extents the call leaves to the entry point
    are the data's own (``tile_extents_of``), which the kernels' wrappers
    derive alike; a dense backend skips no stripe."""
    blocks = tuple(kwargs.get("blocks", DEFAULT_BLOCKS))
    backend = kwargs.get("backend")
    if entry == "butterfly_update":
        a, b, s, ids_a, _ids_b = args
        body = kwargs.get("body", "peel")
        kmax_a, kmax_b = kwargs.get("kmax_a"), kwargs.get("kmax_b")
        n_a, n_v = a.shape
        if body == "count":
            if _sparse(backend) and kmax_a is not None:
                ops = count_pair_ops(a, s, kmax_a, blocks)
                nbytes = (_live_stripe_bytes(kmax_a, kmax_a, n_a, n_a, n_v,
                                             blocks, same=True)
                          + 4.0 * (3 * n_a + kmax_a.numel()))
            else:
                ops = count_pair_ops(a, s)
                nbytes = 4.0 * (n_a * n_v + 3 * n_a)
            return bound(ops, nbytes)
        if _sparse(backend) and kmax_a is not None and kmax_b is not None:
            ops, nbytes, _ = peel_live_work(a, b, s, kmax_a, kmax_b, blocks)
        else:
            ops, nbytes, _ = peel_live_work(a, b, s)
        return bound(ops, nbytes)
    if entry == "butterfly_update_batched":
        a, b, s, _ids_a, _ids_b = args
        kmax_a, kmax_b = kwargs.get("kmax_a"), kwargs.get("kmax_b")
        if _sparse(backend) and kmax_a is not None and kmax_b is not None:
            return bound(*stack_peel_live_work(a, b, s, kmax_a, kmax_b,
                                               blocks))
        return bound(*stack_peel_live_work(a, b, s))
    if entry == "b2_stack":
        (a,) = args
        bi, bj, bk = blocks
        g_n, m = a.shape[:2]
        kmax_a = tile_extents_of(a, bi, bk)
        kmax_b = kmax_a if bi == bj else tile_extents_of(a, bj, bk)
        ops = b2_pair_ops(a, kmax_a, kmax_b, blocks)
        nbytes = 4.0 * (a.numel() + g_n * m * m + kmax_a.numel()
                        + kmax_b.numel())
        return bound(ops, nbytes)
    if entry == "butterfly_update_tiled":
        td, _srow, scol, _sptr, pos, slot_live, s = args
        return bound(*tiled_peel_live_work(td, scol, pos, slot_live, s))
    return None
