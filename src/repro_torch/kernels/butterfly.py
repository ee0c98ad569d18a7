"""Fused butterfly update: CUDA kernel wrappers and their plain versions.

    out[i] = sum_{j : ids_b[j] != ids_a[i]} s[j] * C((A B^T)[i, j], 2)

This is the wedge-traversal hot loop of RECEIPT — per-vertex counting,
batched CD peel updates and HUC recounts are all this op (DESIGN.md
section 2.1):

    counting / recount:  A = B = biadjacency,  s = alive mask
    CD peel update:      A = biadjacency, B = gathered peel rows A[S],
                         s = validity of gathered rows (padding mask)

``ids_a`` / ``ids_b`` carry the row ids of each side so self-pairs (u, u)
are excluded even when B holds gathered copies of A rows.

The operands are f32 (0/1 matrices, a 0/1 ``s``) and the output is f64:
each wedge count W is an exact integer (s32 on the tensor cores), and from
``C(W, 2)`` on every body and every plain version sums in f64, exact for
every support below 2^53 (DESIGN.md section 8, the port's paragraph).

Two kernels, launched with no stripe extents (each source notes the
Pallas kernels it replaces, what bounds it on the H100 and how it is
built):

* ``butterfly_update``         kernel 1, one graph, global ids;
* ``butterfly_update_batched`` kernel 2, a (G, ...) stack, local ids.

Kernel 1 (and kernel 4, ``butterfly_sparse``) has three bodies, and the
caller names one (``body``):

* ``"peel"``, the default, for the gathered peel updates: int8
  ``mma.sync`` over only the stripes the rows with ``s`` mass touch
  (``csrc/butterfly_sparse.cu``);
* ``"count"`` for counting and HUC recounts (``ops.butterfly_support``,
  the engine's ``support_all``): int8 ``wgmma`` fed by TMA over the tile
  pairs I <= J of the symmetric W = A A^T (``csrc/butterfly_count.cu``).
  It takes only that form: ``b`` must be ``a``, ``ids_b`` ``ids_a`` (and
  kernel 4's ``kmax_b`` ``kmax_a``), the same storage, or it raises;
* ``"tile"``, the f32 FMA tile (``csrc/butterfly_sparse.cu``,
  ``wedge_tile.cuh``) that computed every form before the other two:
  the yardstick they are timed against.

Kernel 2 (and kernel 5) has two of them, ``STACK_BODIES``: ``"peel"``,
the default (the same peel body over the stack, group g in
``gridDim.z``, four stripes a K-stage), and ``"tile"``.

Each body counts its launches under its own key,
``"<kernel>[count]"``, ``"[peel]"`` and ``"[tile]"``.

Each wrapper takes its plain version (beside it) for CPU tensors and
launches its kernel for CUDA tensors, counting the launch in ``LAUNCHES``.
On meta tensors (the dry run) it runs the plain version for the shapes,
and a cost mode books the body's own work (``peel_work``,
``count_work``) in its place (``utils.op_cost.run_kernel``).
There is no fallback from one to the other.  ``_launch`` is the one
launch of those bodies, shared with the stripe-skipping kernels 4 and 5
(``butterfly_sparse``); ``check_body`` and ``check_stack_body`` hold a
call to its body's form on every device.
"""
from __future__ import annotations

import torch

from . import _build
from ._build import check_launch, ptr, stream_of

__all__ = [
    "LAUNCHES",
    "BODIES",
    "STACK_BODIES",
    "check_body",
    "check_stack_body",
    "count_scratch_bytes",
    "peel_scratch_bytes",
    "peel_work",
    "count_work",
    "butterfly_update",
    "butterfly_update_plain",
    "butterfly_update_batched",
    "butterfly_update_batched_plain",
]

BODIES = ("count", "peel", "tile")
_F64 = torch.float64
STACK_BODIES = ("peel", "tile")

# launches of each kernel body (plain calls are not counted)
LAUNCHES = {"butterfly_update[count]": 0, "butterfly_update[peel]": 0,
            "butterfly_update[tile]": 0,
            "butterfly_update_batched[peel]": 0,
            "butterfly_update_batched[tile]": 0}

# the peel body's geometry (csrc/butterfly_sparse.cu: KS, PB)
_STRIPE = 32
_PEEL_CHUNK = 128
# the count body's tile and K-stage (csrc/butterfly_count.cu: CT, CK)
_COUNT_TILE = 128


def count_scratch_bytes(n: int, n_v: int) -> int:
    """Device scratch of the count body (``count_scratch_bytes`` of
    ``csrc/butterfly_count.cu``): the s8 copy of A, zero-padded to
    128-row tiles and a 128-byte column pitch."""
    def pad(x):
        return -(-x // _COUNT_TILE) * _COUNT_TILE
    return pad(n) * pad(n_v)


def _same(x, y) -> bool:
    """The same storage seen the same way (no read of either tensor)."""
    if x is None or y is None:
        return x is y
    return (x.data_ptr() == y.data_ptr() and x.shape == y.shape
            and x.stride() == y.stride() and x.dtype == y.dtype
            and x.device == y.device)


def check_body(body, a, b, ids_a, ids_b, kmax_a=None, kmax_b=None):
    """Raise unless ``body`` is one of ``BODIES`` and the operands are its
    form: the count body takes only B = A (``b`` is ``a``, ``ids_b`` is
    ``ids_a``, ``kmax_b`` is ``kmax_a``: the same storage)."""
    if body not in BODIES:
        raise ValueError(f"body {body!r}: one of {BODIES}")
    if body == "count" and not (_same(a, b) and _same(ids_a, ids_b)
                                and _same(kmax_a, kmax_b)):
        raise ValueError(
            "body 'count' is the counting form: b must be a, ids_b ids_a "
            "and kmax_b kmax_a (the same storage); other operands take "
            "body 'peel' or 'tile'")


def check_stack_body(body):
    """Raise unless ``body`` is one of ``STACK_BODIES``."""
    if body not in STACK_BODIES:
        raise ValueError(f"body {body!r}: a stack takes one of "
                         f"{STACK_BODIES}")


def peel_scratch_bytes(n_b: int, n_v: int, groups: int = 1) -> int:
    """Device scratch of the peel body over ``groups`` graphs
    (``peel_scratch_bytes`` of ``csrc/butterfly_sparse.cu``): per chunk
    of 128 gathered rows of each graph, one int32 flag per 32-column
    stripe (all the flags rounded up to 16 bytes), then the chunk's rows
    as s8, 32 bytes per stripe."""
    n_str = -(-n_v // _STRIPE)
    n_chunks = groups * -(-n_b // _PEEL_CHUNK)
    flag_bytes = -(-4 * n_chunks * n_str // 16) * 16
    return flag_bytes + n_chunks * _PEEL_CHUNK * n_str * _STRIPE


def peel_work(n_a: int, n_b: int, n_v: int, groups: int = 1):
    """(operations, bytes) of the peel body over ``groups`` graphs with
    every row valid and every stripe live (``chip_smoke.peel_live_work``
    with no data): 2 per (A row, B row, column); A, B, s and both ids
    moved once in f32 / int32, out in f64."""
    ops = 2 * n_a * n_b * n_v
    nbytes = 4 * (n_a * n_v + n_b * n_v + 2 * n_b + n_a) + 8 * n_a
    return groups * ops, groups * nbytes


def count_work(n: int, n_v: int):
    """(operations, bytes) of the count body (B = A) with every row
    holding mass and every stripe live (``chip_smoke.count_pair_ops``
    with no data): 2 per unordered pair of distinct rows per column; A,
    s and the ids moved once, the f64 out once."""
    return (n * n - n) * n_v, 4 * (n * n_v + 2 * n) + 8 * n


def _on_meta(plain, a, b, s, ids_a, ids_b, body, groups=1):
    """The plain version on meta tensors, costed as ``body``'s work."""
    from ..utils.op_cost import run_kernel

    n_a, n_v = a.shape[-2:]
    n_b = b.shape[-2]
    if body == "count":
        ops, nbytes = count_work(n_a, n_v)
        scratch = count_scratch_bytes(n_a, n_v)
    else:
        ops, nbytes = peel_work(n_a, n_b, n_v, groups)
        scratch = peel_scratch_bytes(n_b, n_v, groups) if body == "peel" \
            else 0
    return run_kernel(plain, (a, b, s, ids_a, ids_b), ops=ops,
                      nbytes=nbytes, scratch=scratch,
                      unit="fp32" if body == "tile" else "int8")


def butterfly_update_plain(a, b, s, ids_a, ids_b):
    """Plain version of kernel 1 (materializes the (n_a, n_b) wedge
    matrix the kernel keeps on chip): W in the operands' dtype (exact
    integers below 2^24), C(W, 2) and the sums in f64."""
    w = (a @ b.T).to(_F64)
    b2 = w * (w - 1.0) * 0.5
    not_self = (ids_a[:, None] != ids_b[None, :]).to(_F64)
    return (b2 * not_self) @ s.to(_F64)


def butterfly_update_batched_plain(a, b, s, ids_a, ids_b):
    """Plain version of kernel 2 (f64 from C(W, 2) on, as kernel 1's)."""
    w = torch.einsum("gic,gjc->gij", a, b).to(_F64)
    b2 = w * (w - 1.0) * 0.5
    not_self = (ids_a[:, :, None] != ids_b[:, None, :]).to(_F64)
    return torch.einsum("gij,gj->gi", b2 * not_self, s.to(_F64))


def _check(a, b, s, ids_a, ids_b, *, batched: bool):
    nd = 3 if batched else 2
    for name, t, dt, dims in (("a", a, torch.float32, nd),
                              ("b", b, torch.float32, nd),
                              ("s", s, torch.float32, nd - 1),
                              ("ids_a", ids_a, torch.int32, nd - 1),
                              ("ids_b", ids_b, torch.int32, nd - 1)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != dims:
            raise ValueError(f"{name} must have {dims} dims, got {t.dim()}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead = a.shape[:-2]
    n_a, n_v = a.shape[-2:]
    n_b = b.shape[-2]
    if (b.shape != (*lead, n_b, n_v) or s.shape != (*lead, n_b)
            or ids_a.shape != (*lead, n_a) or ids_b.shape != (*lead, n_b)):
        raise ValueError(
            f"inconsistent shapes a{tuple(a.shape)} b{tuple(b.shape)} "
            f"s{tuple(s.shape)} ids_a{tuple(ids_a.shape)} "
            f"ids_b{tuple(ids_b.shape)}")


def _launch(counts, name, a, b, s, ids_a, ids_b, kmax_a=None, kmax_b=None,
            blocks=(1, 1, 1), body="tile"):
    """Launch a wedge-update body on CUDA operands and count it in
    ``counts`` under ``name[body]``.  3-D operands are a stack (the group
    is gridDim.z) and take the peel or tile body; 2-D ones are one graph
    and take any of ``BODIES``.  Without extents every stripe is read
    (kernels 1 and 2); with ``kmax_a``/``kmax_b`` of ``blocks`` row tiles
    the K loop stops at the covering tiles' extents (kernels 4 and 5; the
    count body takes square tiles, bi == bj).  The public wrappers check
    the body's form first (``check_body``, ``check_stack_body``)."""
    if a.device.type != "cuda":
        raise ValueError(f"no butterfly kernel for device {a.device}")
    batched = a.dim() == 3
    _check(a, b, s, ids_a, ids_b, batched=batched)
    skip = kmax_a is not None
    if skip != (kmax_b is not None):
        raise ValueError("kmax_a and kmax_b come together")
    if batched:
        check_stack_body(body)
    key = f"{name}[{body}]"
    bi, bj, bk = (int(x) for x in blocks)
    if body == "count" and skip and bi != bj:
        raise ValueError(f"the count body's extents need square tiles, got "
                         f"blocks {tuple(blocks)}")
    g_n = a.shape[0] if batched else 1
    n_a, n_v = a.shape[-2:]
    n_b = b.shape[-2]
    out = torch.zeros(a.shape[:-1], dtype=_F64, device=a.device)
    if not (g_n and n_a and n_b and n_v):
        return out
    if body == "count":
        n_scratch = count_scratch_bytes(n_a, n_v)
        # the s8 copy of A; freed on return, as the peel body's scratch
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=a.device)
        check_launch(_build.library("butterfly_count").butterfly_count_f32(
            ptr(a), ptr(s), ptr(ids_a), ptr(kmax_a) if skip else None,
            ptr(out), n_a, n_v, bi, bk, ptr(scratch), n_scratch,
            stream_of(a)), key)
        counts[key] += 1
        return out
    lib = _build.library("butterfly_sparse")
    extents = ((ptr(kmax_a), ptr(kmax_b)) if skip else (None, None))
    n_ta = kmax_a.shape[-1] if skip else 0
    n_tb = kmax_b.shape[-1] if skip else 0
    if body == "peel":
        n_scratch = peel_scratch_bytes(n_b, n_v, g_n)
        # freed on return: the caching allocator hands it out again only to
        # work queued after the kernels on this stream
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=a.device)
        check_launch(lib.butterfly_update_peel_f32(
            ptr(a), ptr(b), ptr(s), ptr(ids_a), ptr(ids_b), *extents,
            ptr(out), g_n, n_a, n_b, n_v, n_ta, n_tb, bi, bj, bk,
            int(batched), ptr(scratch), n_scratch, stream_of(a)), key)
    else:
        check_launch(lib.butterfly_update_sparse_f32(
            ptr(a), ptr(b), ptr(s), ptr(ids_a), ptr(ids_b), *extents,
            ptr(out), g_n, n_a, n_b, n_v, n_ta, n_tb, bi, bj, bk,
            stream_of(a)), key)
    counts[key] += 1
    return out


def butterfly_update(a, b, s, ids_a, ids_b, *, body="peel"):
    """Kernel 1.  a (n_a, n_v) f32 0/1, b (n_b, n_v), s (n_b,) f32,
    ids_a (n_a,) / ids_b (n_b,) int32; returns out (n_a,) f64.  ``body``
    (one of ``BODIES``) is the body launched on CUDA tensors; its form is
    checked on every device."""
    check_body(body, a, b, ids_a, ids_b)
    if a.device.type == "cpu":
        return butterfly_update_plain(a, b, s, ids_a, ids_b)
    if a.device.type == "meta":
        return _on_meta(butterfly_update_plain, a, b, s, ids_a, ids_b, body)
    return _launch(LAUNCHES, "butterfly_update", a, b, s, ids_a, ids_b,
                   body=body)


def butterfly_update_batched(a, b, s, ids_a, ids_b, *, body="peel"):
    """Kernel 2.  a (G, n_a, n_v) f32 0/1, b (G, n_b, n_v), s (G, n_b),
    ids_a (G, n_a) / ids_b (G, n_b) int32 local ids; returns (G, n_a)
    f64.
    ``body`` (one of ``STACK_BODIES``) is the body launched on CUDA
    tensors; it is checked on every device."""
    check_stack_body(body)
    if a.device.type == "cpu":
        return butterfly_update_batched_plain(a, b, s, ids_a, ids_b)
    if a.device.type == "meta":
        return _on_meta(butterfly_update_batched_plain, a, b, s, ids_a,
                        ids_b, body, groups=a.shape[0])
    return _launch(LAUNCHES, "butterfly_update_batched", a, b, s, ids_a,
                   ids_b, body=body)
