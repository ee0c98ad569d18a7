"""The benchmark's graph and mutation generator, so the yardstick's data
does not move with the program.

A graph is drawn from a ``numpy`` seed (an int or a sequence of ints), its
U and V endpoints independently with probabilities proportional to
``rank ** (-1 / (alpha - 1))`` (a bipartite Chung-Lu graph whose expected
degrees follow a power law of exponent ``alpha`` on each side).

* ``powerlaw_edges`` is a frozen copy of the port's generator
  (``repro_torch.core.graph.powerlaw_bipartite``): ``k = 1.3 m + 16``
  endpoint pairs, deduplicated, so it realises fewer than ``m`` edges
  (``powerlaw_edges(6486, 12942, 96662, seed=0)`` gives 82,255).
* ``powerlaw_edges_exact``, which the cells draw with, keeps drawing
  until it holds exactly ``m`` distinct edges: the first ``m`` distinct
  pairs of the drawn stream.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["chung_lu_weights", "powerlaw_edges", "powerlaw_edges_exact",
           "edge_keys", "mutation_batches"]


def chung_lu_weights(n: int, m_target: int, alpha: float) -> np.ndarray:
    """Sampling probabilities of one side: expected degrees proportional
    to ``rank ** (-1 / (alpha - 1))``, normalised to sum to 1."""
    w = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (alpha - 1.0))
    w *= m_target / w.sum()
    return w / w.sum()


def powerlaw_edges(n_u: int, n_v: int, m_target: int, alpha_u: float = 2.0,
                   alpha_v: float = 2.0, seed=0) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Distinct edges ``(eu, ev)`` (int32, sorted by ``u * n_v + v``) of a
    Chung-Lu bipartite graph with power-law expected degrees."""
    rng = np.random.default_rng(seed)
    pu = chung_lu_weights(n_u, m_target, alpha_u)
    pv = chung_lu_weights(n_v, m_target, alpha_v)
    k = int(m_target * 1.3) + 16
    eu = rng.choice(n_u, size=k, p=pu)
    ev = rng.choice(n_v, size=k, p=pv)
    key = np.unique(eu.astype(np.int64) * n_v + ev.astype(np.int64))
    return (key // n_v).astype(np.int32), (key % n_v).astype(np.int32)


def powerlaw_edges_exact(n_u: int, n_v: int, m: int, alpha_u: float = 2.0,
                         alpha_v: float = 2.0, seed=0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Exactly ``m`` distinct edges ``(eu, ev)`` (int32, sorted by
    ``u * n_v + v``): the first ``m`` distinct endpoint pairs of a stream
    drawn by the Chung-Lu weights of both sides."""
    if m > n_u * n_v:
        raise ValueError(f"{m} edges do not fit a {n_u} x {n_v} graph")
    rng = np.random.default_rng(seed)
    cu = np.cumsum(chung_lu_weights(n_u, m, alpha_u))
    cv = np.cumsum(chung_lu_weights(n_v, m, alpha_v))
    keys = np.empty(0, np.int64)
    while keys.size < m:
        k = 2 * (m - keys.size) + 16
        u = np.minimum(np.searchsorted(cu, rng.random(k), side="right"),
                       n_u - 1)
        v = np.minimum(np.searchsorted(cv, rng.random(k), side="right"),
                       n_v - 1)
        cand = u.astype(np.int64) * n_v + v
        _, first = np.unique(cand, return_index=True)
        cand = cand[np.sort(first)]                  # in drawn order
        cand = cand[~_member(cand, np.sort(keys))]
        keys = np.concatenate([keys, cand[: m - keys.size]])
    keys = np.sort(keys)
    return (keys // n_v).astype(np.int32), (keys % n_v).astype(np.int32)


def edge_keys(eu, ev, n_v: int) -> np.ndarray:
    """Sorted distinct edge keys ``u * n_v + v`` (int64)."""
    return np.unique(np.asarray(eu, np.int64) * n_v + np.asarray(ev, np.int64))


def mutation_batches(keys: np.ndarray, n_u: int, n_v: int, m_target: int,
                     alpha_u: float, alpha_v: float, fraction: float,
                     delete_share: float, cycles: int, seed
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``cycles`` mutation batches applied one after the other to the
    graph of edge keys ``keys``.  Each batch changes ``fraction`` of the
    current edges: ``delete_share`` of them deletions of present edges
    drawn uniformly, the rest insertions of absent pairs drawn by the
    graph's own Chung-Lu weights.  Returns ``[(deleted keys, inserted
    keys), ...]``, each sorted int64."""
    rng = np.random.default_rng(seed)
    pu = chung_lu_weights(n_u, m_target, alpha_u)
    pv = chung_lu_weights(n_v, m_target, alpha_v)
    cur = np.asarray(keys, np.int64)
    out = []
    for _ in range(cycles):
        size = max(2, int(round(fraction * cur.size)))
        n_del = int(round(delete_share * size))
        n_ins = size - n_del
        dels = np.sort(cur[rng.choice(cur.size, size=n_del, replace=False)])
        ins = np.empty(0, np.int64)
        while ins.size < n_ins:
            draw = 2 * (n_ins - ins.size) + 16
            cand = (rng.choice(n_u, size=draw, p=pu).astype(np.int64) * n_v
                    + rng.choice(n_v, size=draw, p=pv))
            cand = cand[~_member(cand, cur)]
            _, first = np.unique(cand, return_index=True)
            cand = cand[np.sort(first)]              # in drawn order
            cand = cand[~_member(cand, np.sort(ins))]
            ins = np.concatenate([ins, cand[: n_ins - ins.size]])
        ins = np.sort(ins)
        keep = np.ones(cur.size, bool)
        keep[np.searchsorted(cur, dels)] = False
        cur = np.sort(np.concatenate([cur[keep], ins]))
        out.append((dels, ins))
    return out


def _member(x: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    """``np.isin(x, sorted_keys)`` for sorted distinct ``sorted_keys``."""
    if not sorted_keys.size:
        return np.zeros(x.shape, bool)
    at = np.minimum(np.searchsorted(sorted_keys, x), sorted_keys.size - 1)
    return sorted_keys[at] == x
