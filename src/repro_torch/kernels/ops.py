"""Backend registry and dispatching entry points of the butterfly kernels.

``butterfly_support(a, s)`` / ``butterfly_update(a, b, s, ids_a, ids_b)``
are THE hot ops of the engine: per-vertex counting, CD batched peel
updates and HUC recounts are all these ops with different masks/rows;
``butterfly_update_batched`` and ``b2_stack`` carry the FD level peel;
``butterfly_update_tiled`` is the same update in mask form over the
nonzero-tile list of the tiled representation.
``find_hi_device`` and ``tighten_extents_device`` are the whole-graph CD
loop's on-device range choice and staircase refresh (plain tensor code).
``edge_support_all`` / ``edge_support_delta`` are the edge axis's closed
form and its peel delta (wing peeling; no Pallas body in the reference,
so two plain matrix products here), and ``vertex_support_edge_delta`` the
refresh's per-vertex delta of an edge mutation (two counting calls:
kernel 1's count body, kernel 4's on the sparse backends).

Backends:
    "cuda"          the hand-written sm_90a kernels (``kernels/csrc``), on
                    CUDA tensors only: kernels 1-3, and kernel 6 for the
                    tiled update
    "cuda_sparse"   the same with the staircase stripe skip: kernels 4-5
                    for every update, kernel 3 for the B2 stack, kernel 6
                    for the tiled update (the tile list has no slot for a
                    zero stripe, so it skips them already)
    "torch"         the kernels' plain PyTorch versions, on CPU tensors
    "torch_sparse"  the plain versions of the stripe-skipping kernels (and
                    of kernel 6)

``None`` resolves from the tensors' device: CUDA tensors go to the dense
hand kernels, CPU tensors to their plain versions.  A backend that does
not match the tensors' device raises; nothing degrades from one backend to
another, from sparse to dense or from a kernel to its plain version.  The
reference package's backend names are mapped only by
``repro_torch.convert.config_from_fields``.

The kernels mask ragged edges themselves, so unlike the reference's Pallas
entry points no shape has to be padded to ``blocks``; ``blocks`` still sets
the stripe geometry of the extents.  The sparse backends take row-tile
extents ``kmax_a`` / ``kmax_b``; without them every stripe is live.
"""
from __future__ import annotations

import difflib
from typing import Optional

import torch

from . import butterfly as _bfly
from . import butterfly_sparse as _sparse
from . import butterfly_tiled as _tiled

__all__ = [
    "DEFAULT_BLOCKS",
    "KNOWN_BACKENDS",
    "SPARSE_BACKENDS",
    "butterfly_update",
    "butterfly_support",
    "butterfly_update_batched",
    "b2_stack",
    "butterfly_update_tiled",
    "find_hi_device",
    "tighten_extents_device",
    "edge_support_all",
    "edge_support_delta",
    "vertex_support_edge_delta",
    "default_backend",
    "resolve_backend",
    "route_label",
    "fallback_chain",
    "launch_counts",
    "reset_launch_counts",
]

DEFAULT_BLOCKS = (128, 128, 512)
SPARSE_BACKENDS = ("cuda_sparse", "torch_sparse")
KNOWN_BACKENDS = ("cuda", "torch") + SPARSE_BACKENDS
_CARD_BACKENDS = ("cuda", "cuda_sparse")

_ROUTE_LABELS = {
    "cuda": "cuda (hand-written sm_90a kernels)",
    "cuda_sparse": "cuda_sparse (hand-written sm_90a staircase kernels)",
    "torch": "torch (plain PyTorch versions of the kernels)",
    "torch_sparse": "torch_sparse (plain PyTorch versions of the staircase "
                    "kernels)",
}


def default_backend(device) -> str:
    """The backend for tensors on ``device``."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def resolve_backend(backend: Optional[str], device=None) -> str:
    """Validate + resolve a backend name.

    ``None`` resolves from ``device`` (the card when no device is given).
    With a ``device``, a backend that cannot run there raises: ``"cuda"``
    and ``"cuda_sparse"`` need CUDA tensors, ``"torch"`` and
    ``"torch_sparse"`` run only on CPU tensors.
    """
    if backend is not None and backend not in KNOWN_BACKENDS:
        hints = difflib.get_close_matches(backend, KNOWN_BACKENDS, n=1)
        hint = f" (did you mean {hints[0]!r}?)" if hints else ""
        raise ValueError(
            f"unknown kernel backend {backend!r}{hint}; known backends: "
            f"{', '.join(KNOWN_BACKENDS)}")
    if device is None:
        return backend or "cuda"
    dev = torch.device(device)
    if backend is None:
        return default_backend(dev)
    if backend in _CARD_BACKENDS and dev.type != "cuda":
        raise ValueError(
            f"backend {backend!r} launches the hand kernels on CUDA tensors; "
            f"got tensors on {dev}")
    if backend not in _CARD_BACKENDS and dev.type == "cuda":
        raise ValueError(
            f"backend {backend!r} (the plain versions) runs on CPU tensors "
            "only; CUDA tensors go through the hand kernels")
    return backend


def route_label(backend: Optional[str]) -> str:
    """Human-readable kernel route of a backend."""
    return _ROUTE_LABELS[resolve_backend(backend)]


def fallback_chain(backend: Optional[str]) -> tuple:
    """The degradation chain starting AT ``backend``: the backend alone —
    no backend degrades to another (a failed kernel raises)."""
    return (resolve_backend(backend),)


def launch_counts() -> dict:
    """Launches of each hand kernel since the last reset."""
    return {**_bfly.LAUNCHES, **_sparse.LAUNCHES, **_tiled.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_bfly.LAUNCHES, _sparse.LAUNCHES, _tiled.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _f32(t):
    return t.to(torch.float32).contiguous()


def _i32(t):
    return t.to(torch.int32).contiguous()


def _full_extents(lead, n_rows: int, block_rows: int, n_v: int, block_k: int,
                  device):
    """Extents that skip no stripe: every row tile reaches the last one."""
    return torch.full((*lead, -(-n_rows // block_rows)), -(-n_v // block_k),
                      dtype=torch.int32, device=device)


def _sparse_extents(a, b, kmax_a, kmax_b, blocks):
    """The extents of both sides as int32, full ones where none is given;
    the counting form (``b`` is ``a``, ``kmax_b`` is ``kmax_a``, square
    tiles) keeps one tensor for both."""
    bi, bj, bk = blocks
    lead, n_v = tuple(a.shape[:-2]), a.shape[-1]
    shared = b is a and kmax_b is kmax_a and bi == bj
    if kmax_a is None:
        kmax_a = _full_extents(lead, a.shape[-2], bi, n_v, bk, a.device)
    kmax_a = _i32(kmax_a)
    if shared:
        return kmax_a, kmax_a
    if kmax_b is None:
        kmax_b = _full_extents(lead, b.shape[-2], bj, n_v, bk, a.device)
    return kmax_a, _i32(kmax_b)


def butterfly_update(a, b, s, ids_a, ids_b, *, backend=None,
                     blocks=DEFAULT_BLOCKS, kmax_a=None, kmax_b=None,
                     body="peel"):
    """out[i] = sum_{j: ids_b[j] != ids_a[i]} s[j] * C((A B^T)[i, j], 2).

    The general (gathered peel set) form: kernel 1, or kernel 4 on the
    sparse backends, which read the row-tile extents ``kmax_a``
    ((ceil(n_a/bi),) int32) and ``kmax_b`` ((ceil(n_b/bj),)).  ``body``
    is the kernel body on the card: ``"peel"`` for a gathered peel update,
    ``"count"`` for counting and HUC recounts (``b`` is ``a``, ``ids_b``
    is ``ids_a`` and ``kmax_b`` is ``kmax_a``; every row may carry ``s``
    mass), ``"tile"`` the f32 yardstick body.  A tensor passed for both
    sides stays one tensor through the conversions.
    """
    backend = resolve_backend(backend, a.device)
    a32, ids_a32 = _f32(a), _i32(ids_a)
    args = (a32, a32 if b is a else _f32(b), _f32(s), ids_a32,
            ids_a32 if ids_b is ids_a else _i32(ids_b))
    if backend in SPARSE_BACKENDS:
        return _sparse.butterfly_update_sparse(
            *args, *_sparse_extents(a, b, kmax_a, kmax_b, blocks),
            blocks=blocks, body=body)
    return _bfly.butterfly_update(*args, body=body)


def butterfly_update_batched(a, b, s, ids_a, ids_b, *, backend=None,
                             blocks=DEFAULT_BLOCKS, kmax_a=None, kmax_b=None):
    """Grouped butterfly update over a stack of independent subgraphs
    (the FD level-peel hot op, kernel 2; kernel 5 on the sparse backends):

        out[g, i] = sum_{j: ids_b[g,j] != ids_a[g,i]} s[g,j]
                    * C((A_g B_g^T)[i, j], 2)

    a: (G, n_a, n_v); b: (G, n_b, n_v); s: (G, n_b); ids (G, n) LOCAL
    row ids; ``kmax_a`` / ``kmax_b`` per-group row-tile extents
    ((G, ceil(n_a/bi)) / (G, ceil(n_b/bj)) int32) for the sparse backends.
    """
    backend = resolve_backend(backend, a.device)
    args = (_f32(a), _f32(b), _f32(s), _i32(ids_a), _i32(ids_b))
    if backend in SPARSE_BACKENDS:
        return _sparse.butterfly_update_sparse_batched(
            *args, *_sparse_extents(a, b, kmax_a, kmax_b, blocks),
            blocks=blocks)
    return _bfly.butterfly_update_batched(*args)


def b2_stack(a, *, backend=None, blocks=DEFAULT_BLOCKS):
    """Pairwise-butterfly stack ``out[g, x, y] = C((A_g A_g^T)[x, y], 2)``
    with the diagonal zeroed — the ``fd_update_mode="b2"`` precompute
    (kernel 3, on every backend).

    The stripe extents are derived on the device from the rows
    themselves: per-row extents in ``bk``-column stripes, reduced over
    ``bi``-row tiles; when ``bi != bj`` the B-side tile extents are rebuilt
    at ``bj`` granularity from the same per-row upper bound.
    """
    resolve_backend(backend, a.device)
    a = _f32(a)
    bi, bj, bk = blocks
    m = a.shape[1]
    kmax_a = _sparse.column_extents(a, bi, bk)
    if bi != bj:
        per_row = kmax_a.repeat_interleave(bi, dim=1)[:, :m]
        kmax_b = _sparse.tile_extents(per_row, bj)
    else:
        kmax_b = kmax_a
    return _sparse.b2_stack(a, _i32(kmax_a), _i32(kmax_b), blocks=blocks)


def butterfly_support(a, s, *, backend=None, blocks=DEFAULT_BLOCKS,
                      kmax=None):
    """out[i] = sum_{j != i} s[j] * C((A A^T)[i, j], 2)  (counting form).

    a: (n_u, n_v) 0/1 float tensor; s: (n_u,) mask; ``kmax`` the shared
    row-tile extents on the sparse backends (square tiles, bi == bj).
    Returns f64 (n_u,), as every kernel here from ``C(W, 2)`` on.
    """
    ids = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
    return butterfly_update(a, a, s, ids, ids, backend=backend,
                            blocks=blocks, kmax_a=kmax, kmax_b=kmax,
                            body="count")


def butterfly_update_tiled(tile_data, srow, scol, sptr, pos, slot_live, s, *,
                           backend=None, n_srows=None):
    """Mask-form butterfly update over a nonzero-tile list
    (``core.graph.TiledGraph`` arrays):

        out[x] = sum_{y != x} s[y] * C((A A^T)[x, y], 2)

    Kernel 6 on ``"cuda"`` / ``"cuda_sparse"``, its plain version on
    ``"torch"`` / ``"torch_sparse"``; ``None`` resolves from the tensors'
    device.  ``n_srows``, the number of nonzero entries of ``s`` when the
    caller has it, sizes kernel 6's scratch (or picks the plain version's
    path) without a read.
    """
    resolve_backend(backend, tile_data.device)
    return _tiled.butterfly_update_tiled(
        _f32(tile_data), _i32(srow), _i32(scol), _i32(sptr), _i32(pos),
        _i32(slot_live), _f32(s), n_srows=n_srows)


# ---------------------------------------------------------------------- #
# whole-graph CD helpers (plain tensor code, no kernel)
# ---------------------------------------------------------------------- #
def find_hi_device(support, alive, w, tgt):
    """Adaptive range upper bound (Alg. 3 findHi) on the device.

    Sort alive supports ascending (stable), prefix-sum their wedge counts
    ``w`` in f32 and return ``s + 1`` for the smallest support ``s`` whose
    cumulative mass reaches ``tgt``; when the target exceeds the remaining
    mass (``tgt = inf`` included), ``max(alive support) + 1`` — the
    catch-all bound.  Device twin of ``engine.cd.find_hi_np``; the f32
    prefix sums are exact while the residual wedge mass stays below 2^24
    (DESIGN.md section 8: past it they move the bound, never a support).
    The bound itself is a support plus one in the supports' dtype (f64 in
    the engine: exact below 2^53).  Returns a 0-dim tensor, with no read
    of the device (the pick is a gather, not an index by a 0-dim tensor,
    which PyTorch would read on the host).
    """
    sup = torch.where(alive, support, float("inf"))
    order = torch.argsort(sup, stable=True)
    ws = torch.where(alive, w, 0.0).to(torch.float32)[order]
    hit = torch.cumsum(ws, dim=0) >= tgt
    first = torch.argmax(hit.to(torch.uint8)).view(1)
    hi_hit = sup[order].gather(0, first).squeeze(0)
    hi_max = torch.where(alive, support, float("-inf")).amax()
    return torch.where(hit.any(), hi_hit, hi_max) + 1.0


def tighten_extents_device(a, n_live_cols, *, block_rows, block_k):
    """Staircase extents of the compacted residual graph, on the device.

    After an on-device DGM boundary (dead rows zeroed, live columns
    gathered into a prefix of ``n_live_cols``), every row's nonzeros lie
    inside the prefix, so the per-row extents are clamped at
    ``ceil(n_live_cols / block_k)``.  Returns ``(row_ext, kmax)``: per-row
    extents (n_rows,) int32 (the B-side source of
    ``gathered_tile_extents``) and row-tile extents (ceil(n_rows /
    block_rows),) int32.
    """
    ext = _sparse.row_extents_device(a, block_k)
    n_live = torch.as_tensor(n_live_cols, device=ext.device)
    cap = (n_live + block_k - 1) // block_k
    ext = torch.minimum(ext, cap.to(torch.int32))
    return ext, _sparse.tile_extents(ext, block_rows)


# ---------------------------------------------------------------------- #
# edge-axis entry points (wing peeling; the refresh's vertex delta)
# ---------------------------------------------------------------------- #
def edge_support_all(a, eu, ev, *, backend=None, blocks=DEFAULT_BLOCKS,
                     members=None):
    """Per-edge butterfly supports of a residual graph, closed form:

        b(u, v) = [A (A^T A)](u, v) - d_u(u) - d_v(v) + 1   (alive edges)

    gathered at the edge slots ``(eu, ev)``; absent cells (peeled edges,
    padding slots) report 0.  ``a`` is (R, C) with ``eu``/``ev`` (E,), or
    a stack (G, R, C) with ``eu``/``ev`` (E,) or (G, E), taken member by
    member (so the float64 temporaries are one member's); ``members``
    (host ints), when given, limits the count to those members and the
    others report 0 (the FD loop skips the drained ones).  Returns f32
    shaped like the slots broadcast over the stack.

    The two products are plain matrix products (the reference has no
    Pallas body here), computed in float64 whatever the caller's float32
    matmul precision: ``A^T A`` holds co-degrees past 2048, which a TF32
    product would round, and float64 holds every integer below 2^53 (the
    supports themselves stay below 2^24, DESIGN.md section 8); the card
    runs them on its FP64 tensor cores.  ``backend``/``blocks`` are
    validated for signature parity.
    """
    resolve_backend(backend, a.device)
    if a.dim() == 2:
        return _edge_supports(a, eu, ev)
    g_n = a.shape[0]
    eu = eu.expand(g_n, -1) if eu.dim() == 1 else eu
    ev = ev.expand(g_n, -1) if ev.dim() == 1 else ev
    out = torch.zeros(eu.shape, dtype=torch.float32, device=a.device)
    for g in (range(g_n) if members is None else members):
        out[g] = _edge_supports(a[g], eu[g], ev[g])
    return out


def _edge_supports(a, eu, ev):
    """The closed form of one (R, C) matrix at its slots (float64 products
    and sums, f32 out)."""
    a64 = a.to(torch.float64)
    ata = a64.transpose(0, 1) @ a64
    m3 = a64 @ ata
    del ata
    eu, ev = eu.long(), ev.long()
    b = m3[eu, ev] - a64.sum(dim=1)[eu] - a64.sum(dim=0)[ev] + 1.0
    return (b * a64[eu, ev]).to(torch.float32)


def zero_cells_(a, rows, cols, on):
    """Zero the cells ``(rows[i], cols[i])`` of ``a`` IN PLACE where
    ``on[i]`` (``a`` contiguous; a stack (G, R, C) takes (G, E) or
    broadcast (E,) indices per member).  A bool mask is set at the cells'
    flat offsets, the others parked on a spare slot, so slots that repeat
    a cell or alias one with ``on`` False are harmless.  Returns ``a``."""
    r, c = a.shape[-2:]
    flat = rows.long() * c + cols.long()
    if a.dim() == 3:
        flat = flat + torch.arange(a.shape[0], device=a.device)[:, None] * (
            r * c)
    hit = torch.zeros(a.numel() + 1, dtype=torch.bool, device=a.device)
    hit[torch.where(on.to(torch.bool), flat, a.numel())] = True
    a.view(-1).masked_fill_(hit[:-1], 0.0)
    return a


def edge_support_delta(a, eu, ev, rows, valid, *, backend=None,
                       blocks=DEFAULT_BLOCKS):
    """Support decrease of every edge slot after removing the edge set
    ``rows`` (slot indices into ``eu``/``ev``, ``valid`` masking the real
    entries) from ``a``, as before-minus-after of ``edge_support_all``.

    The reference composes the per-edge masked-matvec / rank-1 deltas
    sequentially (a ``fori_loop`` of a dozen full-matrix passes per edge)
    and states that the sum equals before-minus-after of the closed form;
    here that difference is computed directly, two closed forms for any
    size of set.  Equal on every slot the engine reads: alive edges
    outside the set, absent cells (0 both ways) and padding slots that
    alias a surviving cell.  By design they may differ on the removed
    slots themselves (``apply_delta`` masks those) and on sets that name
    a slot twice or an absent cell, which the reference's composition
    charges and the engine never passes (its sets are the alive peel set).
    Returns f32 shaped like ``eu``.
    """
    resolve_backend(backend, a.device)
    e = rows.long()
    after = zero_cells_(a.clone(), eu.long()[e], ev.long()[e], valid)
    return edge_support_all(a, eu, ev) - edge_support_all(after, eu, ev)


def vertex_support_edge_delta(a, mu, mv, valid, *, backend=None,
                              blocks=DEFAULT_BLOCKS):
    """Butterfly-support decrease of every U row after removing the edges
    ``(mu[i], mv[i])`` (``valid`` masking padding entries) from ``a``:
    count(before) - count(after), two counting calls (kernel 1's count
    body on the card, kernel 4's on the sparse backends, whose extents
    are ``a``'s: removing edges never widens a row).

    The reference composes per-edge masked matvecs sequentially and
    states that the sum equals before-minus-after of the counting
    kernel; the difference is taken here directly, and agrees on every
    row: a slot that repeats an edge, names an absent cell or is padding
    removes nothing, as the reference's gate on ``a[u, v]`` makes it.
    Run it on the union graph with the inserted set for per-vertex gains,
    with the deleted set for losses.  Returns f64 (n_u,), >= 0.
    """
    backend = resolve_backend(backend, a.device)
    bi, _bj, bk = blocks
    a = _f32(a)
    after = zero_cells_(a.clone(), mu, mv, valid)
    kmax = (_sparse.column_extents(a, bi, bk).to(torch.int32)
            if backend in SPARSE_BACKENDS else None)
    ones = torch.ones(a.shape[0], dtype=torch.float32, device=a.device)
    before = butterfly_support(a, ones, backend=backend, blocks=blocks,
                               kmax=kmax)
    return before - butterfly_support(after, ones, backend=backend,
                                      blocks=blocks, kmax=kmax)
