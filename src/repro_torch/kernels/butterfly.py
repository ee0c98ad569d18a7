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

Two kernels, both launches of the one wedge-update body of
``csrc/butterfly_sparse.cu`` with no stripe extents (the source notes the
Pallas kernels it replaces, what bounds it on the H100 and how it is
built):

* ``butterfly_update``         kernel 1, one graph, global ids;
* ``butterfly_update_batched`` kernel 2, a (G, ...) stack, local ids.

Each wrapper takes its plain version (beside it) for CPU tensors and
launches its kernel for CUDA tensors, counting the launch in ``LAUNCHES``.
There is no fallback from one to the other.  ``_launch`` is that body's
one launch, shared with the stripe-skipping kernels 4 and 5
(``butterfly_sparse``).
"""
from __future__ import annotations

import torch

from . import _build
from ._build import check_launch, ptr, stream_of

__all__ = [
    "LAUNCHES",
    "butterfly_update",
    "butterfly_update_plain",
    "butterfly_update_batched",
    "butterfly_update_batched_plain",
]

# launches of each kernel (plain calls are not counted)
LAUNCHES = {"butterfly_update": 0, "butterfly_update_batched": 0}


def butterfly_update_plain(a, b, s, ids_a, ids_b):
    """Plain version of kernel 1 (materializes the (n_a, n_b) wedge
    matrix the kernel keeps on chip)."""
    w = a @ b.T
    b2 = w * (w - 1.0) * 0.5
    not_self = (ids_a[:, None] != ids_b[None, :]).to(a.dtype)
    return (b2 * not_self) @ s.to(a.dtype)


def butterfly_update_batched_plain(a, b, s, ids_a, ids_b):
    """Plain version of kernel 2."""
    w = torch.einsum("gic,gjc->gij", a, b)
    b2 = w * (w - 1.0) * 0.5
    not_self = (ids_a[:, :, None] != ids_b[:, None, :]).to(a.dtype)
    return torch.einsum("gij,gj->gi", b2 * not_self, s.to(a.dtype))


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


def _launch(counts, key, a, b, s, ids_a, ids_b, kmax_a=None, kmax_b=None,
            blocks=(1, 1, 1)):
    """Launch the wedge-update kernel of ``csrc/butterfly_sparse.cu`` on
    CUDA operands (2-D: one graph; 3-D: the group is gridDim.z) and count
    it in ``counts[key]``.  Without extents every stripe is read (kernels
    1 and 2); with ``kmax_a``/``kmax_b`` of ``blocks`` row tiles the K loop
    stops at the covering tiles' extents (kernels 4 and 5)."""
    if a.device.type != "cuda":
        raise ValueError(f"no butterfly kernel for device {a.device}")
    batched = a.dim() == 3
    _check(a, b, s, ids_a, ids_b, batched=batched)
    skip = kmax_a is not None
    if skip != (kmax_b is not None):
        raise ValueError("kmax_a and kmax_b come together")
    bi, bj, bk = (int(x) for x in blocks)
    g_n = a.shape[0] if batched else 1
    n_a, n_v = a.shape[-2:]
    n_b = b.shape[-2]
    out = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    if g_n and n_a and n_b and n_v:
        lib = _build.library("butterfly_sparse")
        check_launch(lib.butterfly_update_sparse_f32(
            ptr(a), ptr(b), ptr(s), ptr(ids_a), ptr(ids_b),
            ptr(kmax_a) if skip else None, ptr(kmax_b) if skip else None,
            ptr(out), g_n, n_a, n_b, n_v,
            kmax_a.shape[-1] if skip else 0, kmax_b.shape[-1] if skip else 0,
            bi, bj, bk, stream_of(a)), key)
        counts[key] += 1
    return out


def butterfly_update(a, b, s, ids_a, ids_b):
    """Kernel 1.  a (n_a, n_v) f32 0/1, b (n_b, n_v), s (n_b,) f32,
    ids_a (n_a,) / ids_b (n_b,) int32; returns out (n_a,) f32."""
    if a.device.type == "cpu":
        return butterfly_update_plain(a, b, s, ids_a, ids_b)
    return _launch(LAUNCHES, "butterfly_update", a, b, s, ids_a, ids_b)


def butterfly_update_batched(a, b, s, ids_a, ids_b):
    """Kernel 2.  a (G, n_a, n_v) f32 0/1, b (G, n_b, n_v), s (G, n_b),
    ids_a (G, n_a) / ids_b (G, n_b) int32 local ids; returns (G, n_a)."""
    if a.device.type == "cpu":
        return butterfly_update_batched_plain(a, b, s, ids_a, ids_b)
    return _launch(LAUNCHES, "butterfly_update_batched", a, b, s, ids_a,
                   ids_b)
