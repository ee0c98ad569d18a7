"""Synthetic inputs (port of ``repro.data.synthetic``): token streams
(LM), random graphs with consistent masks and triplets (GNN), interaction
batches (recsys) and ``interaction_graph``.  Every draw is the reference's
numpy draw in its order, so the same seed gives the same arrays; each
builder hands them over as tensors on ``device`` (None: the card).  The
one exception is GraphSAGE's sampled blocks, whose neighbour draws come
from a ``torch.Generator`` (``models/sampler.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.engine.peel_loop import resolve_device
from ..core.graph import BipartiteGraph, powerlaw_bipartite

__all__ = ["interaction_graph", "lm_train_batch", "lm_token_stream",
           "random_graph", "meshgraphnet_batch", "graphsage_full_batch",
           "graphsage_sampled_batch", "build_triplets", "dimenet_batch",
           "graphcast_batch", "recsys_batch"]


def _on(arrays, device):
    """The numpy ``arrays`` as tensors on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def lm_train_batch(vocab: int, batch: int, seq: int, seed: int = 0,
                   device=None):
    """``tokens`` and ``labels`` (B, S) int32 (the labels are the tokens
    shifted by one), on ``device`` (None: the card)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return _on({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, device)


def lm_token_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                    device=None):
    """Infinite deterministic token stream (for the train driver)."""
    step = 0
    while True:
        yield lm_train_batch(vocab, batch, seq, seed=seed + step,
                             device=device)
        step += 1


# --------------------------------------------------------------------- #
# GNN
# --------------------------------------------------------------------- #
def random_graph(n_nodes: int, n_edges: int, seed: int = 0):
    """(senders, receivers) int32 numpy arrays, uniform endpoints."""
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    rcv = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    return snd, rcv


def meshgraphnet_batch(cfg, n_nodes: int, n_edges: int, seed: int = 0,
                       device=None):
    rng = np.random.default_rng(seed)
    snd, rcv = random_graph(n_nodes, n_edges, seed)
    return _on({
        "node_feats": rng.normal(size=(n_nodes, cfg.d_node_in)).astype(np.float32),
        "edge_feats": rng.normal(size=(n_edges, cfg.d_edge_in)).astype(np.float32),
        "senders": snd,
        "receivers": rcv,
        "edge_mask": np.ones((n_edges,), np.float32),
        "targets": rng.normal(size=(n_nodes, cfg.d_out)).astype(np.float32),
    }, device)


def graphsage_full_batch(cfg, n_nodes: int, n_edges: int, seed: int = 0,
                         device=None):
    rng = np.random.default_rng(seed)
    snd, rcv = random_graph(n_nodes, n_edges, seed)
    return _on({
        "node_feats": rng.normal(size=(n_nodes, cfg.d_in)).astype(np.float32),
        "senders": snd,
        "receivers": rcv,
        "edge_mask": np.ones((n_edges,), np.float32),
        "labels": rng.integers(0, cfg.n_classes, n_nodes, dtype=np.int32),
        "node_mask": np.ones((n_nodes,), np.float32),
    }, device)


def graphsage_sampled_batch(cfg, batch_nodes: int, fanouts, n_nodes: int,
                            n_edges: int, seed: int = 0, device=None):
    """Run the REAL sampler (models/sampler.py) over a random graph: the
    table built on ``device``, the neighbours drawn by a
    ``torch.Generator`` there seeded with ``seed``; the graph, features,
    seeds and labels are the reference's numpy draws."""
    from ..models.sampler import build_nbr_table, sample_blocks

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    snd, rcv = random_graph(n_nodes, n_edges, seed)
    table, deg = build_nbr_table(snd, rcv, n_nodes, max_deg=32, device=dev)
    feats = rng.normal(size=(n_nodes, cfg.d_in)).astype(np.float32)
    seeds = rng.choice(n_nodes, size=batch_nodes, replace=False).astype(np.int32)
    host = _on({"feats": feats, "seeds": seeds}, dev)
    blocks = sample_blocks(torch.Generator(device=dev).manual_seed(seed),
                           table, deg, host["feats"], host["seeds"], fanouts)
    blocks["labels"] = torch.from_numpy(
        rng.integers(0, cfg.n_classes, batch_nodes, dtype=np.int32)).to(dev)
    return blocks


_TRIPLET_CHUNK = 1 << 22         # candidate pairs expanded at a time


def build_triplets(snd: np.ndarray, rcv: np.ndarray, max_triplets: int,
                   seed: int = 0):
    """Real triplet table: pairs (kj, ji) of edges sharing node j
    (k -> j -> i), truncated at max_triplets.

    The reference's loop order, vectorized: edge ji ascending, then the
    edges kj into its sender j in edge order (a stable sort by receiver),
    dropping k == i, the first ``max_triplets`` kept.  The candidates are
    expanded a chunk of ji edges at a time, and the expansion stops once
    ``max_triplets`` are found.  Returns (kj, ji) int32 and the mask
    float32, zero-padded to ``max_triplets``."""
    snd = np.asarray(snd).astype(np.int64)
    rcv = np.asarray(rcv).astype(np.int64)
    n_edges = len(snd)
    n = int(max(snd.max(), rcv.max())) + 1 if n_edges else 0
    by_dst = np.argsort(rcv, kind="stable")
    counts = np.bincount(rcv, minlength=n)
    start = np.cumsum(counts) - counts
    cand = np.cumsum(counts[snd])        # candidates through edge ji
    kj_parts, ji_parts = [], []
    found, lo = 0, 0
    while lo < n_edges and found < max_triplets:
        # the ji edges whose candidates fit one chunk (one edge at least)
        base = int(cand[lo - 1]) if lo else 0
        hi = max(int(np.searchsorted(cand, base + _TRIPLET_CHUNK,
                                     side="right")), lo + 1)
        ji = np.arange(lo, min(hi, n_edges))
        c = counts[snd[ji]]
        ji_rep = np.repeat(ji, c)
        first = np.cumsum(c) - c
        off = np.arange(len(ji_rep)) - np.repeat(first, c)
        kj = by_dst[np.repeat(start[snd[ji]], c) + off]
        keep = snd[kj] != rcv[ji_rep]                    # k != i
        kj_parts.append(kj[keep])
        ji_parts.append(ji_rep[keep])
        found += int(keep.sum())
        lo = hi
    kj = np.concatenate(kj_parts)[:max_triplets] if kj_parts else np.zeros(0)
    ji = np.concatenate(ji_parts)[:max_triplets] if ji_parts else np.zeros(0)
    t = len(kj)
    pad = max_triplets - t
    return (
        np.concatenate([kj, np.zeros(pad)]).astype(np.int32),
        np.concatenate([ji, np.zeros(pad)]).astype(np.int32),
        np.concatenate([np.ones(t, np.float32), np.zeros(pad, np.float32)]),
    )


def dimenet_batch(cfg, n_nodes: int, n_edges: int, n_graphs: int = 1,
                  triplet_fanout: int = 8, seed: int = 0, device=None):
    rng = np.random.default_rng(seed)
    snd, rcv = random_graph(n_nodes, n_edges, seed)
    max_t = n_edges * triplet_fanout
    kj, ji, tmask = build_triplets(snd, rcv, max_t, seed)
    batch = {
        "node_feats": rng.normal(size=(n_nodes, cfg.d_node_in)).astype(np.float32),
        "positions": rng.normal(size=(n_nodes, 3)).astype(np.float32),
        "senders": snd,
        "receivers": rcv,
        "edge_mask": np.ones((n_edges,), np.float32),
        "trip_kj": kj,
        "trip_ji": ji,
        "trip_mask": tmask,
    }
    if n_graphs > 1:
        gid = np.repeat(np.arange(n_graphs), n_nodes // n_graphs)
        gid = np.pad(gid, (0, n_nodes - len(gid)), constant_values=n_graphs - 1)
        batch["graph_id"] = gid.astype(np.int32)
        batch["targets"] = rng.normal(size=(n_graphs,)).astype(np.float32)
    else:
        batch["targets"] = rng.normal(size=(1,)).astype(np.float32)
    return _on(batch, device)


def graphcast_batch(cfg, n_grid: int, seed: int = 0, device=None):
    rng = np.random.default_rng(seed)
    nm = getattr(cfg, "n_mesh_nodes_padded", cfg.n_mesh_nodes)
    em = getattr(cfg, "n_mesh_edges_padded", cfg.n_mesh_edges)
    e_g2m, e_m2g = 4 * n_grid, 3 * n_grid

    def edges(n_e, n_src, n_dst):
        return (
            rng.integers(0, n_src, n_e, dtype=np.int32),
            rng.integers(0, n_dst, n_e, dtype=np.int32),
        )

    g2m_s, g2m_r = edges(e_g2m, n_grid, nm)
    m_s, m_r = edges(em, nm, nm)
    m2g_s, m2g_r = edges(e_m2g, nm, n_grid)
    f32 = np.float32
    return _on({
        "grid_feats": rng.normal(size=(n_grid, cfg.n_vars)).astype(f32),
        "mesh_feats": rng.normal(size=(nm, 4)).astype(f32),
        "g2m_senders": g2m_s, "g2m_receivers": g2m_r,
        "g2m_feats": rng.normal(size=(e_g2m, 4)).astype(f32),
        "g2m_mask": np.ones((e_g2m,), f32),
        "mesh_senders": m_s, "mesh_receivers": m_r,
        "mesh_efeats": rng.normal(size=(em, 4)).astype(f32),
        "mesh_mask": np.ones((em,), f32),
        "m2g_senders": m2g_s, "m2g_receivers": m2g_r,
        "m2g_feats": rng.normal(size=(e_m2g, 4)).astype(f32),
        "m2g_mask": np.ones((e_m2g,), f32),
        "targets": rng.normal(size=(n_grid, cfg.n_vars)).astype(f32),
    }, device)


def recsys_batch(cfg, batch: int, seed: int = 0, with_logq: bool = True,
                 device=None):
    """A two-tower batch: ``user_ids`` (B, F_u, W), ``item_ids``
    (B, F_i, W) int32 and ``item_logq`` (B,) float32, from the reference's
    numpy draws (the same seed gives the same ids and ``item_logq``), as
    tensors on ``device`` (None: the card)."""
    rng = np.random.default_rng(seed)
    w = cfg.values_per_field

    def ids(fields):
        cols = [
            rng.integers(0, v, (batch, 1, w), dtype=np.int32) for v in fields
        ]
        return np.concatenate(cols, axis=1)

    out = {
        "user_ids": ids(cfg.user_fields),
        "item_ids": ids(cfg.item_fields),
    }
    if with_logq:
        out["item_logq"] = np.log(
            rng.uniform(1e-6, 1e-3, batch)).astype(np.float32)
    return _on(out, device)


def interaction_graph(n_users: int, n_items: int, n_inter: int,
                      seed: int = 0) -> BipartiteGraph:
    """Bipartite user-item interaction graph — RECEIPT's input in the
    recsys integration (examples/recsys_tip_filtering_torch.py)."""
    return powerlaw_bipartite(n_users, n_items, n_inter, seed=seed)
