"""Reference peeling algorithms + metric oracles (host-side, exact numpy).

The port's copy of ``repro.core.peeling``:

* ``bup_oracle``     — Alg. 2 of the paper (sequential bottom-up peeling),
                       exact int64.  The correctness ground truth for every
                       RECEIPT engine, and the BUP baseline of Table 3.
* ``parb_metrics``   — ParBatch-style round counting: every round peels ALL
                       vertices holding the current minimum support (this is
                       how the paper derives rho for ParB, footnote 6).
* both return a ``PeelMetrics`` with the paper's evaluation counters:
  wedges traversed and synchronization rounds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import BipartiteGraph

__all__ = ["PeelMetrics", "bup_oracle", "parb_metrics", "shared_butterfly_matrix"]


@dataclasses.dataclass
class PeelMetrics:
    rounds: int = 0            # synchronization rounds (rho)
    wedges: int = 0            # residual-graph wedges actually traversed
    wedges_static: int = 0     # the paper's ∧BUP metric (footnote 6):
                               # static 2-hop neighbourhood aggregation
    updates: int = 0           # support updates applied


def shared_butterfly_matrix(g: BipartiteGraph) -> np.ndarray:
    """B2[i, j] = C(W[i, j], 2), zero diagonal, exact int64."""
    a = g.dense(dtype=np.int64)[: g.n_u, : g.n_v]
    w = a @ a.T
    b2 = w * (w - 1) // 2
    np.fill_diagonal(b2, 0)
    return b2


def bup_oracle(g: BipartiteGraph):
    """Sequential bottom-up peeling (Alg. 2).  Returns (theta, metrics).

    Wedge accounting follows the paper: peeling u traverses
    sum_{v in N_u} (d_v - 1) wedges in the *current* graph (we track V-side
    degrees of the residual graph), and pvBcnt wedges are not included here
    (they are reported separately by benchmarks).
    """
    b2 = shared_butterfly_matrix(g)
    support = b2.sum(axis=1)
    theta = np.zeros(g.n_u, dtype=np.int64)
    alive = np.ones(g.n_u, dtype=bool)
    m = PeelMetrics()

    # residual V degrees for wedge accounting
    indptr_u, indices_u = g.csr_u()
    dv = g.degrees_v().copy()
    m.wedges_static = int(g.wedge_counts_u().sum())

    order = []
    for _ in range(g.n_u):
        cand = np.where(alive)[0]
        u = cand[np.argmin(support[cand])]
        th = support[u]
        theta[u] = th
        alive[u] = False
        order.append(u)
        # wedge traversal in the residual graph
        nbrs = indices_u[indptr_u[u] : indptr_u[u + 1]]
        m.wedges += int((dv[nbrs] - 1).sum())
        dv[nbrs] -= 1
        # support updates, capped at theta_u (Alg. 2 line 13)
        upd = b2[u] > 0
        upd &= alive
        m.updates += int(upd.sum())
        support[upd] = np.maximum(th, support[upd] - b2[u][upd])
        m.rounds += 1
    return theta, m


def parb_metrics(g: BipartiteGraph):
    """ParB-style peeling: each round removes every min-support vertex.

    Returns (theta, metrics) — theta matches BUP; metrics.rounds is the
    paper's rho for ParB (footnote 6: retrieve all vertices with minimum
    support in a single iteration).
    """
    b2 = shared_butterfly_matrix(g)
    support = b2.sum(axis=1)
    theta = np.zeros(g.n_u, dtype=np.int64)
    alive = np.ones(g.n_u, dtype=bool)
    m = PeelMetrics()

    indptr_u, indices_u = g.csr_u()
    dv = g.degrees_v().copy()
    m.wedges_static = int(g.wedge_counts_u().sum())

    while alive.any():
        cand = np.where(alive)[0]
        mn = support[cand].min()
        peel = cand[support[cand] == mn]
        theta[peel] = mn
        alive[peel] = False
        for u in peel:
            nbrs = indices_u[indptr_u[u] : indptr_u[u + 1]]
            m.wedges += int((dv[nbrs] - 1).sum())
            dv[nbrs] -= 1
        delta = b2[peel].sum(axis=0)
        upd = alive & (delta > 0)
        m.updates += int(upd.sum())
        support[upd] = np.maximum(mn, support[upd] - delta[upd])
        m.rounds += 1
    return theta, m
