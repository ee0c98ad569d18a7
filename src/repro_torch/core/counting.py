"""Per-vertex butterfly counting (pvBcnt): dense-kernel and segment paths
(port of ``repro.core.counting``).

Two engines, one contract:

* ``butterfly_counts_dense``  — the blocked fused kernel path
  (``kernels.ops.butterfly_support`` with s = ones): kernel 1 on the card,
  its plain version on the CPU.  Cost: |U|^2 |V| products.
* ``butterfly_counts_segment`` — the sparse scatter-reduce path: wedges are
  enumerated into an ordered-pair table on the host (``wedge_pair_table``,
  exactly the traversal Alg. 1 performs), then counted with a sort and a
  segment sum (``index_add_``).  The engine of choice when the wedge table
  is far smaller than |U|^2.

Both are exact; ``butterfly_counts_numpy`` is the int64 oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .graph import BipartiteGraph

__all__ = [
    "butterfly_counts_dense",
    "wedge_pair_table",
    "butterfly_counts_segment",
    "butterfly_counts_numpy",
]


def butterfly_counts_dense(a: torch.Tensor,
                           alive: Optional[torch.Tensor] = None, *,
                           backend: Optional[str] = None) -> torch.Tensor:
    """Per-vertex butterfly counts from the dense 0/1 biadjacency.

    alive: optional (n_u,) mask — counts only butterflies among alive rows
    (the HUC recount op); dead output rows are ignored by callers.
    """
    n_u = a.shape[0]
    s = (torch.ones(n_u, dtype=a.dtype, device=a.device) if alive is None
         else alive.to(a.dtype))
    return kops.butterfly_support(a, s, backend=backend)


def wedge_pair_table(g: BipartiteGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Enumerate all ordered wedge endpoint pairs (u, u'), u != u'.

    For every v in V and every ordered pair of distinct neighbours (u, u')
    of v there is one wedge (u, v, u').  The table has sum_v d_v (d_v - 1)
    rows.  Host-side numpy; this *is* the wedge traversal, made into data.
    """
    indptr, indices = g.csr_v()
    deg = np.diff(indptr)
    reps = deg * (deg - 1)
    total = int(reps.sum())
    if total == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64))
    us = np.empty(total, dtype=np.int64)
    ups = np.empty(total, dtype=np.int64)
    pos = 0
    for v in range(g.n_v):
        nb = indices[indptr[v]: indptr[v + 1]]
        d = len(nb)
        if d < 2:
            continue
        # ordered pairs (x, y), x != y
        x = np.repeat(nb, d - 1)
        y = np.concatenate([np.delete(nb, i) for i in range(d)])
        k = d * (d - 1)
        us[pos: pos + k] = x
        ups[pos: pos + k] = y
        pos += k
    return us[:pos], ups[:pos]


def butterfly_counts_segment(us: torch.Tensor, ups: torch.Tensor,
                             n_u: int) -> torch.Tensor:
    """Exact per-vertex butterfly counts from the ordered wedge-pair table.

    For each ordered pair key (u, u'): W = multiplicity of the key; the
    pair contributes C(W, 2) butterflies to u (the mirrored key handles
    u').  A sort, then run lengths by ``index_add_`` over segment ids —
    fixed shapes, no read of the device.  The keys are int64, so unlike
    the reference (int32 keys without x64) any ``n_u`` below 2^31 works.
    """
    n = us.shape[0]
    dev = us.device
    if n == 0:
        return torch.zeros(n_u, dtype=torch.float32, device=dev)
    key = us.to(torch.int64) * n_u + ups.to(torch.int64)
    sk = torch.sort(key).values
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sk[1:] != sk[:-1]
    seg_id = torch.cumsum(is_start.to(torch.int64), dim=0) - 1
    # multiplicity of each distinct ordered pair
    counts = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
        0, seg_id, torch.ones(n, dtype=torch.float32, device=dev))
    # owner u of each segment (every key of a segment has the same u);
    # segment ids past the last one stay -1
    owner = torch.full((n,), -1, dtype=torch.int64, device=dev).scatter_(
        0, seg_id, torch.div(sk, n_u, rounding_mode="floor"))
    b = counts * (counts - 1.0) * 0.5
    valid = owner >= 0
    return torch.zeros(n_u, dtype=torch.float32, device=dev).index_add_(
        0, torch.where(valid, owner, 0), torch.where(valid, b, 0.0))


def butterfly_counts_numpy(g: BipartiteGraph) -> np.ndarray:
    """Exact int64 per-vertex butterfly counts (test oracle)."""
    a = g.dense(dtype=np.int64)[: g.n_u, : g.n_v]
    w = a @ a.T
    b2 = w * (w - 1) // 2
    np.fill_diagonal(b2, 0)
    return b2.sum(axis=1)
