"""Backend registry and dispatching entry points of the butterfly kernels.

``butterfly_support(a, s)`` / ``butterfly_update(a, b, s, ids_a, ids_b)``
are THE hot ops of the engine: per-vertex counting, CD batched peel
updates and HUC recounts are all these ops with different masks/rows;
``butterfly_update_batched`` and ``b2_stack`` carry the FD level peel.

Backends:
    "cuda"   the hand-written sm_90a kernels (``kernels/csrc``), on CUDA
             tensors only
    "torch"  the kernels' plain PyTorch versions, on CPU tensors only

``None`` resolves from the tensors' device: CUDA tensors go to the hand
kernels, CPU tensors to the plain versions.  A backend that does not match
the tensors' device raises; nothing degrades from one backend to the
other.  The reference package's backend names are mapped only by
``repro_torch.convert.config_from_fields``.

The kernels mask ragged edges themselves, so unlike the reference's Pallas
entry points no shape has to be padded to ``blocks``; ``blocks`` still sets
the stripe geometry of the extents ``b2_stack`` derives.
"""
from __future__ import annotations

import difflib
from typing import Optional

import torch

from . import butterfly as _bfly
from . import butterfly_sparse as _sparse

__all__ = [
    "DEFAULT_BLOCKS",
    "KNOWN_BACKENDS",
    "butterfly_update",
    "butterfly_support",
    "butterfly_update_batched",
    "b2_stack",
    "default_backend",
    "resolve_backend",
    "route_label",
    "fallback_chain",
    "launch_counts",
    "reset_launch_counts",
]

DEFAULT_BLOCKS = (128, 128, 512)
KNOWN_BACKENDS = ("cuda", "torch")

# the reference's staircase backends: ported with kernels 4-5
_LATER_BACKENDS = {
    "pallas_sparse": "the sparse backend (ROADMAP.md, queue 2 items 4-5)",
    "interpret_sparse": "the sparse backend (ROADMAP.md, queue 2 items 4-5)",
}

_ROUTE_LABELS = {
    "cuda": "cuda (hand-written sm_90a kernels)",
    "torch": "torch (plain PyTorch versions of the kernels)",
}


def default_backend(device) -> str:
    """The backend for tensors on ``device``."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def resolve_backend(backend: Optional[str], device=None) -> str:
    """Validate + resolve a backend name.

    ``None`` resolves from ``device`` (the card when no device is given).
    With a ``device``, a backend that cannot run there raises: ``"cuda"``
    needs CUDA tensors, ``"torch"`` runs only on CPU tensors.
    """
    if backend in _LATER_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet: it arrives with "
            f"{_LATER_BACKENDS[backend]}")
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
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"backend 'cuda' launches the hand kernels on CUDA tensors; "
            f"got tensors on {dev}")
    if backend == "torch" and dev.type == "cuda":
        raise ValueError(
            "backend 'torch' (the plain versions) runs on CPU tensors only; "
            "CUDA tensors go through the hand kernels")
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
    return {**_bfly.LAUNCHES, **_sparse.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_bfly.LAUNCHES, _sparse.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _f32(t):
    return t.to(torch.float32).contiguous()


def _i32(t):
    return t.to(torch.int32).contiguous()


def butterfly_update(a, b, s, ids_a, ids_b, *, backend=None,
                     blocks=DEFAULT_BLOCKS):
    """out[i] = sum_{j: ids_b[j] != ids_a[i]} s[j] * C((A B^T)[i, j], 2).

    The general (gathered peel set) form: kernel 1.
    """
    resolve_backend(backend, a.device)
    return _bfly.butterfly_update(_f32(a), _f32(b), _f32(s), _i32(ids_a),
                                  _i32(ids_b))


def butterfly_update_batched(a, b, s, ids_a, ids_b, *, backend=None,
                             blocks=DEFAULT_BLOCKS):
    """Grouped butterfly update over a stack of independent subgraphs
    (the FD level-peel hot op, kernel 2):

        out[g, i] = sum_{j: ids_b[g,j] != ids_a[g,i]} s[g,j]
                    * C((A_g B_g^T)[i, j], 2)

    a: (G, n_a, n_v); b: (G, n_b, n_v); s: (G, n_b); ids (G, n) LOCAL
    row ids.
    """
    resolve_backend(backend, a.device)
    return _bfly.butterfly_update_batched(_f32(a), _f32(b), _f32(s),
                                          _i32(ids_a), _i32(ids_b))


def b2_stack(a, *, backend=None, blocks=DEFAULT_BLOCKS):
    """Pairwise-butterfly stack ``out[g, x, y] = C((A_g A_g^T)[x, y], 2)``
    with the diagonal zeroed — the ``fd_update_mode="b2"`` precompute
    (kernel 3).

    The stripe extents are derived on the device from the rows
    themselves: per-row extents in ``bk``-column stripes, reduced over
    ``bi``-row tiles; when ``bi != bj`` the B-side tile extents are rebuilt
    at ``bj`` granularity from the same per-row upper bound.
    """
    resolve_backend(backend, a.device)
    a = _f32(a)
    bi, bj, bk = blocks
    m = a.shape[1]
    kmax_a = _sparse.tile_extents(_sparse.row_extents_device(a, bk), bi)
    if bi != bj:
        per_row = kmax_a.repeat_interleave(bi, dim=1)[:, :m]
        kmax_b = _sparse.tile_extents(per_row, bj)
    else:
        kmax_b = kmax_a
    return _sparse.b2_stack(a, _i32(kmax_a), _i32(kmax_b), blocks=blocks)


def butterfly_support(a, s, *, backend=None, blocks=DEFAULT_BLOCKS):
    """out[i] = sum_{j != i} s[j] * C((A A^T)[i, j], 2)  (counting form).

    a: (n_u, n_v) 0/1 float tensor; s: (n_u,) mask.
    """
    ids = torch.arange(a.shape[0], dtype=torch.int32, device=a.device)
    return butterfly_update(a, a, s, ids, ids, backend=backend,
                            blocks=blocks)
