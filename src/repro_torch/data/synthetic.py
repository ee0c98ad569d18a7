"""Synthetic graphs (port of ``repro.data.synthetic``'s
``interaction_graph``; the rest of that module, the model batches, comes
with the substrate slice)."""
from __future__ import annotations

from ..core.graph import BipartiteGraph, powerlaw_bipartite

__all__ = ["interaction_graph"]


def interaction_graph(n_users: int, n_items: int, n_inter: int,
                      seed: int = 0) -> BipartiteGraph:
    """Bipartite user-item interaction graph — RECEIPT's input in the
    recsys integration (examples/recsys_tip_filtering.py)."""
    return powerlaw_bipartite(n_users, n_items, n_inter, seed=seed)
