"""Wing decomposition (edge peeling) oracles — port of ``repro.core.wing``
in numpy.

The wing number psi_e of edge e is the largest k such that e survives in
a k-wing (every edge in >= k butterflies within the subgraph).  On a
dense 0/1 matrix the per-edge butterfly count of the residual graph is
closed-form,

    b(u, v) = [A (A^T A)](u, v) - d_u(u) - d_v(v) + 1      (alive edges),

so ``wing_bup_oracle`` recounts after every single-edge peel, and
``wing_decompose`` runs the RECEIPT shape (coarse edge-support ranges,
then a sequential peel of each subset against its residual graph).  The
reference jits its counts and its per-edge FD delta (``_peel_update``);
here both are numpy float64: the FD delta of a peel is before-minus-after
of the closed form, which is the quantity the reference's masked-matvec /
rank-1 delta computes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .graph import BipartiteGraph

__all__ = ["wing_bup_oracle", "wing_decompose", "edge_butterfly_counts"]


def edge_butterfly_counts(a: np.ndarray) -> np.ndarray:
    """b[u, v] for every alive edge of the (possibly partial) 0/1 matrix
    (0 elsewhere)."""
    ata = a.T @ a
    m = a @ ata
    du = a.sum(1, keepdims=True)
    dv = a.sum(0, keepdims=True)
    return (m - du - dv + 1) * (a > 0)


def wing_bup_oracle(g: BipartiteGraph) -> Tuple[np.ndarray, int]:
    """Exact sequential bottom-up edge peeling (int64 numpy).

    Returns (psi[m] aligned with g.edges_*, rounds).  Supports are
    recomputed from the closed form after every peel — O(m * matmul),
    oracle-grade only.
    """
    a = g.dense(dtype=np.int64)[: g.n_u, : g.n_v]
    eu, ev = g.edges_u, g.edges_v
    m = g.m
    psi = np.zeros(m, np.int64)
    alive = np.ones(m, bool)
    rounds = 0
    cur = edge_butterfly_counts(a)[eu, ev].astype(np.int64)
    k = 0
    for _ in range(m):
        cand = np.where(alive)[0]
        e = cand[np.argmin(cur[cand])]
        k = max(k, int(cur[e]))
        psi[e] = k
        alive[e] = False
        a[eu[e], ev[e]] = 0
        cur = edge_butterfly_counts(a)[eu, ev].astype(np.int64)
        rounds += 1
    return psi, rounds


@dataclasses.dataclass
class WingStats:
    rho_cd: int = 0
    num_subsets: int = 0
    bounds: List[float] = dataclasses.field(default_factory=list)


def wing_decompose(
    g: BipartiteGraph, num_partitions: int = 8
) -> Tuple[np.ndarray, WingStats]:
    """Coarse-grained edge-range peeling + exact per-subset FD.

    CD: equal-edge-count ranges over the alive supports, each drained by
    zeroing the peeled edges and recounting the survivors (floored at the
    range's lower bound).  FD: each subset's edges peeled one at a time,
    least support first, against the residual graph of the subset's and
    every higher subset's edges.  Returns (psi int64[m] aligned with
    g.edges_*, WingStats).
    """
    stats = WingStats()
    eu, ev = g.edges_u, g.edges_v
    m = g.m
    a = np.zeros((g.n_u, g.n_v), np.float64)
    a[eu, ev] = 1.0

    # ---- CD: coarse ranges over edge supports (always recount) -------- #
    alive = np.ones(m, bool)
    sup = edge_butterfly_counts(a)[eu, ev]
    subset_id = np.full(m, -1, np.int64)
    init_sup = np.zeros(m, np.float64)
    bounds = [0.0]
    lo = 0.0
    i = 0
    while alive.any():
        catch_all = i >= num_partitions - 1
        init_sup[alive] = sup[alive]
        if catch_all:
            hi = float(np.max(np.where(alive, sup, -np.inf))) + 1.0
        else:
            vals = np.sort(sup[alive])
            tgt = max(len(vals) // max(num_partitions - i, 1), 1)
            hi = float(vals[min(tgt - 1, len(vals) - 1)]) + 1.0
        while True:
            peel = alive & (sup < hi)
            if not peel.any():
                break
            stats.rho_cd += 1
            subset_id[peel] = i
            a[eu[peel], ev[peel]] = 0.0
            alive &= ~peel
            sup = np.where(alive,
                           np.maximum(edge_butterfly_counts(a)[eu, ev], lo),
                           np.inf)
        bounds.append(hi)
        lo = hi
        i += 1
        if catch_all:
            break
    stats.num_subsets = i
    stats.bounds = bounds
    assert (subset_id >= 0).all()

    # ---- FD: per-subset sequential peel on (subset u higher) edges ---- #
    psi = np.zeros(m, np.int64)
    for s in range(i):
        members = np.where(subset_id == s)[0]
        if len(members) == 0:
            continue
        a_res = np.zeros((g.n_u, g.n_v), np.float64)
        ge = subset_id >= s
        a_res[eu[ge], ev[ge]] = 1.0
        mu, mv = eu[members], ev[members]
        sup_m = init_sup[members].copy()
        alive_m = np.ones(len(members), bool)
        before = edge_butterfly_counts(a_res)[mu, mv]
        k = bounds[s]
        for _ in range(len(members)):
            cand = np.where(alive_m)[0]
            j = cand[np.argmin(sup_m[cand])]
            k = max(k, sup_m[j])
            psi[members[j]] = int(round(k))
            alive_m[j] = False
            a_res[mu[j], mv[j]] = 0.0
            after = edge_butterfly_counts(a_res)[mu, mv]
            sup_m = np.where(alive_m,
                             np.maximum(sup_m - (before - after), k), sup_m)
            before = after
    return psi, stats
