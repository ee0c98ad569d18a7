"""Tiled-sparse butterfly kernel (kernel 6) and the tile-list helpers.

The biadjacency is held as a CSR list of its NONZERO ``[bi x bk]`` tiles
(``core.graph.TiledGraph``: ``tile_data``, ``srow``, ``scol``, ``sptr``
and the reverse map ``pos``), so memory and wedge work scale with the
occupied tiles rather than ``rows_pad * cols_pad``.  The kernel computes
the MASK form of the butterfly update (B = A, ``s`` a mask over rows):

    out[x] = sum_{y != x} s[y] * C((A A^T)[x, y], 2)

with ``s`` = the alive mask it is per-vertex butterfly counting, with ``s``
= a peel mask the level-peel support delta of the tiled engine
(``core/engine/tiled.py``).

* ``butterfly_update_tiled``  kernel 6 (``csrc/butterfly_tiled.cu``): the
  wrapper checks its inputs and launches the kernel on CUDA tensors,
  counting the launch in ``LAUNCHES``; CPU tensors take the plain version;
* ``butterfly_update_tiled_plain``  its plain version, the port of the
  reference's streaming oracle ``butterfly_update_tiled_xla``: a
  gathered-row path for masks of at most ``_PEEL_ROW_WIDTH`` rows and a
  band-streaming path for wider ones; neither builds the dense matrix.

The helpers are plain tensor code (they are not Pallas kernels in the
reference either): ``slot_liveness``, ``regather_tiles`` (in place),
``colsum_tiled``, ``masked_colsum_tiled`` and ``row_weights_tiled``.

The plain version picks its gathered or band-streaming path from
``n_srows``, the number of nonzero entries of ``s``, when the caller knows
it (the tiled engine on CPU tensors hands it the peel-set size its sweep
has already read), so choosing reads nothing more.  Kernel 6 needs no such
hint, and its wrapper takes none.

Every product below has 0/1 operands (or a 0/1 mask), so it is exact in
f32 and in TF32 alike, and every sum is an integer below 2^24 (DESIGN.md
section 8): results are bit-identical to the reference in any order.
"""
from __future__ import annotations

import torch

from . import _build
from ._build import check_launch, ptr, stream_of

__all__ = [
    "LAUNCHES",
    "butterfly_update_tiled",
    "butterfly_update_tiled_plain",
    "colsum_tiled",
    "masked_colsum_tiled",
    "regather_tiles",
    "row_weights_tiled",
    "slot_liveness",
]

# fast-path width of the plain version's gathered-row path: a mask with at
# most this many nonzero rows (almost every peel sweep) is densified
# straight from the tile list instead of streaming over every row band
# (the reference's constant)
_PEEL_ROW_WIDTH = 16

# launches of the kernel (plain calls are not counted)
LAUNCHES = {"butterfly_update_tiled": 0}


# ---------------------------------------------------------------------- #
# tile-list helpers
# ---------------------------------------------------------------------- #
def slot_liveness(tile_data: torch.Tensor) -> torch.Tensor:
    """int32[n_slots] — 1 where the tile still has any nonzero."""
    return (tile_data != 0).flatten(1).any(dim=1).to(torch.int32)


def regather_tiles(tile_data, srow, scol, row_keep, col_keep):
    """Tile-list regather, IN PLACE: zero dead rows and columns inside the
    tiles and recompute the slot liveness (the tiled DGM step).

    ``row_keep`` (rows_pad,) and ``col_keep`` (cols_pad,) are 0/1.  A
    column with fewer than 2 alive neighbours completes no wedge between
    alive rows, so zeroing it never changes an alive pair's wedge count
    (the DGM exactness argument).  Slots are deactivated, never removed.
    The reference returns a new payload; here ``tile_data`` is rewritten
    where it lies (two elementwise passes, no payload-sized temporary) and
    returned with the new liveness.
    """
    _n_slots, bi, bk = tile_data.shape
    rmask = row_keep.to(tile_data.dtype).reshape(-1, bi)[srow.long()]
    cmask = col_keep.to(tile_data.dtype).reshape(-1, bk)[scol.long()]
    tile_data.mul_(rmask[:, :, None]).mul_(cmask[:, None, :])
    return tile_data, slot_liveness(tile_data)


def colsum_tiled(tile_data, scol, n_col_tiles: int) -> torch.Tensor:
    """Per-column degree over the tile list: float32[cols_pad]."""
    _n_slots, _bi, bk = tile_data.shape
    per_slot = tile_data.to(torch.float32).sum(dim=1)       # (n_slots, bk)
    out = torch.zeros((n_col_tiles, bk), dtype=torch.float32,
                      device=tile_data.device)
    return out.index_add_(0, scol.long(), per_slot).reshape(-1)


def _first_rows(sf, width: int):
    """The first ``width`` rows of the mask ``sf`` with a nonzero entry,
    ascending, and their weights (padding entries weigh 0).  A stable
    sort, not ``nonzero``: its size is known, so nothing waits for the
    card."""
    order = torch.argsort((sf == 0).to(torch.int8), stable=True)[:width]
    return order, sf[order]


def _gathered_rows(td, pos, yidx, bi):
    """Rows ``yidx`` of the biadjacency, densified from the tile list:
    (R, n_ct, bk), zero where a tile is absent."""
    pslots = pos[torch.div(yidx, bi, rounding_mode="floor")]   # (R, n_ct)
    rows = td[pslots.clamp(min=0).long(), (yidx % bi)[:, None]]
    return rows * (pslots >= 0).to(td.dtype)[:, :, None]


def masked_colsum_tiled(tile_data, srow, scol, pos, s) -> torch.Tensor:
    """``sum_y s[y] * a[y, :]`` over the tile list: float32[cols_pad].

    ``s`` is a 0/1 mask.  With a peel mask this is the peeled rows'
    column-sum vector, the per-sweep wedge-accounting quantity.  The
    reference switches to a gathered-row form for at most
    ``_PEEL_ROW_WIDTH`` nonzero rows; here it is always the full form, one
    batched product over the slot list and a scatter-add: the same sums,
    with no choice to read off the device (PERF.md has both forms' times
    on the card).
    """
    _n_slots, bi, bk = tile_data.shape
    n_rt, n_ct = pos.shape
    sb = s.reshape(n_rt, bi).to(torch.float32)[srow.long()]  # (n_slots, bi)
    per_slot = torch.bmm(sb[:, None, :], tile_data)[:, 0]    # (n_slots, bk)
    out = torch.zeros((n_ct, bk), dtype=torch.float32, device=s.device)
    return out.index_add_(0, scol.long(), per_slot).reshape(-1)


def row_weights_tiled(tile_data, srow, scol, col_w,
                      n_row_tiles: int) -> torch.Tensor:
    """float32[rows_pad] — ``sum_v a[u, v] * col_w[v]`` over the tiles
    (with ``col_w = dv - 1`` the per-vertex wedge workload).  ``col_w``
    may pass 2048, so this is an elementwise product and a sum, exact in
    f32 whatever the TF32 setting."""
    _n_slots, bi, bk = tile_data.shape
    cw = col_w.to(torch.float32).reshape(-1, bk)[scol.long()]  # (n_slots, bk)
    per_slot = (tile_data * cw[:, None, :]).sum(dim=2)         # (n_slots, bi)
    out = torch.zeros((n_row_tiles, bi), dtype=torch.float32,
                      device=tile_data.device)
    return out.index_add_(0, srow.long(), per_slot).reshape(-1)


# ---------------------------------------------------------------------- #
# kernel 6: plain version
# ---------------------------------------------------------------------- #
def butterfly_update_tiled_plain(tile_data, srow, scol, sptr, pos, slot_live,
                                 s, *, n_srows=None):
    """Plain version of kernel 6 (the reference's two-speed streaming
    oracle), never building the dense biadjacency:

    * **gathered rows** — at most ``_PEEL_ROW_WIDTH`` nonzero rows of
      ``s``: those rows are densified from the tile list through ``pos``
      and the needed wedge columns ``W[:, peeled]`` come from one batched
      product over the slot list, summed into row bands by ``srow``;
    * **band streaming** — wider masks: one B row band at a time, each
      band's wedge columns from a batched product of every slot with its
      partner tile in that band.  The reference skips bands without ``s``
      mass on the device; here every band is computed (a band without
      mass adds zero), so the plain version reads nothing of ``s``.

    ``n_srows`` is the number of nonzero entries of ``s`` when the caller
    knows it; without it the mask is counted (a read of ``s``, which on a
    CUDA tensor waits for the card).  The partial products are
    slot-sized; dead slots (``slot_live`` 0) are zeroed in a copy of the
    payload, as in the reference.
    """
    _n_slots, bi, _bk = tile_data.shape
    n_rt, _n_ct = pos.shape
    n_rows = n_rt * bi
    dev = tile_data.device
    ids = torch.arange(n_rows, device=dev)
    sf = s.reshape(n_rows).to(torch.float32)
    td = tile_data * (slot_live > 0).to(torch.float32)[:, None, None]
    srow_l = srow.long()
    width = min(n_rows, _PEEL_ROW_WIDTH)

    def wedge_columns(partner):
        """W[:, cols] from each slot's partner rows (n_slots, R, bk)."""
        partial = torch.bmm(td, partner.transpose(1, 2))   # (n_slots, bi, R)
        w = torch.zeros((n_rt, bi, partner.shape[1]), dtype=torch.float32,
                        device=dev)
        return w.index_add_(0, srow_l, partial).reshape(n_rows, -1)

    if n_srows is None:
        n_srows = int((sf != 0).sum())
    if n_srows <= width:
        yidx, sv = _first_rows(sf, width)
        rows_y = _gathered_rows(td, pos, yidx, bi)          # (R, n_ct, bk)
        w = wedge_columns(rows_y[:, scol.long(), :].transpose(0, 1))
        not_self = (ids[:, None] != yidx[None, :]).to(torch.float32)
        b2 = w * (w - 1.0) * 0.5
        return (b2 * not_self * sv[None, :]).sum(dim=1)

    out = torch.zeros(n_rows, dtype=torch.float32, device=dev)
    s_bands = sf.reshape(n_rt, bi)
    for j in range(n_rt):
        p = pos[j, scol.long()]                              # (n_slots,)
        a_j = (td[p.clamp(min=0).long()]
               * (p >= 0).to(torch.float32)[:, None, None])
        w = wedge_columns(a_j)
        idb = j * bi + torch.arange(bi, device=dev)
        not_self = (ids[:, None] != idb[None, :]).to(torch.float32)
        b2 = w * (w - 1.0) * 0.5
        out += (b2 * not_self * s_bands[j][None, :]).sum(dim=1)
    return out


# ---------------------------------------------------------------------- #
# kernel 6: the CUDA launch
# ---------------------------------------------------------------------- #
def _check(tile_data, srow, scol, sptr, pos, slot_live, s):
    if tile_data.dim() != 3:
        raise ValueError(f"tile_data must be (n_slots, bi, bk), got "
                         f"{tuple(tile_data.shape)}")
    n_slots, bi, _bk = tile_data.shape
    if pos.dim() != 2:
        raise ValueError(f"pos must be (n_rt, n_ct), got {tuple(pos.shape)}")
    n_rt = pos.shape[0]
    for name, t, dt, shape in (
            ("tile_data", tile_data, torch.float32, tuple(tile_data.shape)),
            ("srow", srow, torch.int32, (n_slots,)),
            ("scol", scol, torch.int32, (n_slots,)),
            ("sptr", sptr, torch.int32, (n_rt + 1,)),
            ("pos", pos, torch.int32, tuple(pos.shape)),
            ("slot_live", slot_live, torch.int32, (n_slots,)),
            ("s", s, torch.float32, (n_rt * bi,))):
        if t.device != tile_data.device:
            raise ValueError(f"{name} is on {t.device}, tile_data on "
                             f"{tile_data.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def butterfly_update_tiled(tile_data, srow, scol, sptr, pos, slot_live, s):
    """Kernel 6.  tile_data (n_slots, bi, bk) f32 0/1; srow, scol,
    slot_live (n_slots,), sptr (n_rt + 1,), pos (n_rt, n_ct) int32 (-1 =
    absent tile); s (n_rt * bi,) f32; returns out (n_rt * bi,) f32."""
    if tile_data.device.type == "cpu":
        return butterfly_update_tiled_plain(tile_data, srow, scol, sptr, pos,
                                            slot_live, s)
    if tile_data.device.type != "cuda":
        raise ValueError(f"no tiled butterfly kernel for device "
                         f"{tile_data.device}")
    _check(tile_data, srow, scol, sptr, pos, slot_live, s)
    n_slots, bi, bk = tile_data.shape
    n_rt, n_ct = pos.shape
    out = torch.zeros(n_rt * bi, dtype=torch.float32, device=tile_data.device)
    if n_slots and n_rt and bk:
        lib = _build.library("butterfly_tiled")
        check_launch(lib.butterfly_update_tiled_f32(
            ptr(tile_data), ptr(scol), ptr(sptr), ptr(pos), ptr(slot_live),
            ptr(s), ptr(out), n_rt, n_ct, bi, bk,
            stream_of(tile_data)), "butterfly_update_tiled")
        LAUNCHES["butterfly_update_tiled"] += 1
    return out
