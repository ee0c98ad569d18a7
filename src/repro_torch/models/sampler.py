"""Fixed-fanout neighbour sampler for GraphSAGE minibatch training (port
of ``repro.models.sampler``).

Given a padded-CSR graph on the device, it draws ``fanout`` neighbours per
node per hop (with replacement, as in the GraphSAGE reference
implementation), producing the layered block structure consumed by
``gnn.graphsage_forward_sampled``:

    level 0: seed nodes (batch_nodes,)
    level i: sampled frontier of level i-1, (N_{i-1} * fanout_{i-1},)
    idx_l{i}: (N_i, fanout_i) local indices into level i+1 (-1 = no edge)

Padded CSR: ``nbr_table (N, max_deg)`` int32 with -1 padding + ``deg (N,)``.

The draws come from an explicit ``torch.Generator`` on the table's device
with the reference's slot rule (``r % max(deg, 1)`` of a draw ``r`` in
[0, 2^30)); JAX's random stream is not reproduced.  ``build_nbr_table``
is vectorized (a stable sort by sender and each edge's rank within its
sender) and equal, bit for bit, to the reference's Python loop: the first
``max_deg`` edges of each sender in edge order.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..core.engine.peel_loop import resolve_device

__all__ = ["sample_block", "sample_blocks", "build_nbr_table"]


def sample_block(
    generator: torch.Generator,
    nbr_table: torch.Tensor,     # (N, max_deg) int32, -1 padded
    deg: torch.Tensor,           # (N,) int32
    nodes: torch.Tensor,         # (B,) frontier node ids
    fanout: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``fanout`` neighbours (with replacement) per frontier node.

    Returns (neighbor_ids (B, fanout) global ids with -1 for isolated
    nodes, flat_next (B*fanout,) the next frontier)."""
    nodes = nodes.long()
    b = nodes.shape[0]
    d = deg[nodes].long()                                 # (B,)
    r = torch.randint(0, 1 << 30, (b, fanout), generator=generator,
                      device=nbr_table.device)
    slot = r % torch.clamp(d, min=1)[:, None]
    nb = nbr_table[nodes[:, None], slot]                  # (B, fanout)
    nb = torch.where(d[:, None] > 0, nb, torch.full_like(nb, -1))
    return nb, torch.clamp(nb, min=0).reshape(-1)


def sample_blocks(
    generator: torch.Generator,
    nbr_table: torch.Tensor,
    deg: torch.Tensor,
    feats: torch.Tensor,         # (N, F) node features
    seeds: torch.Tensor,         # (B,)
    fanouts: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """Layered sampling producing the GraphSAGE minibatch dict."""
    out: Dict[str, torch.Tensor] = {}
    frontier = seeds.long()
    out["feats_l0"] = feats[frontier]
    for i, f in enumerate(fanouts):
        nb, nxt = sample_block(generator, nbr_table, deg, frontier, f)
        n_parent = frontier.shape[0]
        # local indices into the next level are just positions 0..B*f-1,
        # masked where the neighbour is missing
        local = torch.arange(n_parent * f, dtype=torch.int32,
                             device=nb.device).reshape(n_parent, f)
        out[f"idx_l{i}"] = torch.where(nb >= 0, local,
                                       torch.full_like(local, -1))
        frontier = nxt.long()
        out[f"feats_l{i+1}"] = feats[frontier]
    return out


def build_nbr_table(senders, receivers, n_nodes: int, max_deg: int,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded CSR of the edges (``nbr_table`` (n_nodes, max_deg) int32,
    -1 padded, and ``deg`` (n_nodes,) int32), truncating each sender at
    ``max_deg`` edges, built on ``device`` (None: the card): the stable
    sort by sender keeps each sender's edges in edge order, and the edges
    of rank below ``max_deg`` within their sender fill its row."""
    dev = resolve_device(device)
    snd = torch.as_tensor(senders).to(dev, torch.int64)
    rcv = torch.as_tensor(receivers).to(dev, torch.int32)
    counts = torch.bincount(snd, minlength=n_nodes)
    snd_sorted, order = torch.sort(snd, stable=True)
    del snd
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(snd_sorted.numel(), device=dev) - start[snd_sorted]
    keep = rank < max_deg
    table = torch.full((n_nodes, max_deg), -1, dtype=torch.int32, device=dev)
    table[snd_sorted[keep], rank[keep]] = rcv[order[keep]]
    deg = torch.clamp(counts, max=max_deg).to(torch.int32)
    return table, deg
