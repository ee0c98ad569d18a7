"""Plain-torch oracles for the butterfly kernels (port of
``repro.kernels.ref``).

They materialize the full |U| x |U| wedge matrix, which is exactly what
the fused kernels avoid.  With A the 0/1 biadjacency of G(U, V, E):

    W  = A A^T                  (pairwise wedge counts; invariant under
                                 peeling because V is never deleted)
    B2 = C(W, 2), zero diag     (pairwise shared butterflies)

    butterfly_support(A, s)[i] = sum_j s[j] * B2[i, j]

which covers (a) per-vertex counting  (s = alive),
             (b) batched peel updates (s = peel set indicator),
             (c) HUC recounts         (s = alive-after-peel).
"""
from __future__ import annotations

import torch

__all__ = ["wedge_matrix", "shared_butterflies", "butterfly_support_ref"]


def wedge_matrix(a: torch.Tensor) -> torch.Tensor:
    """W = A A^T.  a: (n_u, n_v) 0/1 matrix."""
    return a @ a.T


def shared_butterflies(a: torch.Tensor) -> torch.Tensor:
    """B2[i, j] = C(W[i, j], 2) with a zeroed diagonal."""
    w = wedge_matrix(a)
    b2 = w * (w - 1) / 2
    n = a.shape[0]
    return b2 * (1 - torch.eye(n, dtype=a.dtype, device=a.device))


def butterfly_support_ref(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_{j != i} s[j] * C(W[i, j], 2).

    a: (n_u, n_v) 0/1; s: (n_u,) 0/1 row-mask (the "peel set" / alive set).
    """
    b2 = shared_butterflies(a)
    return b2 @ s.to(a.dtype)
