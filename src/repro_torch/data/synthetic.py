"""Synthetic inputs (port of ``repro.data.synthetic``):
``interaction_graph``, the LM token batches (``lm_train_batch``,
``lm_token_stream``) and the recsys batches (``recsys_batch``).  The GNN
batches come with their model slice (ROADMAP.md, queue 1).  Every draw is
the reference's numpy draw, so the same seed gives the same inputs."""
from __future__ import annotations

import numpy as np
import torch

from ..core.engine.peel_loop import resolve_device
from ..core.graph import BipartiteGraph, powerlaw_bipartite

__all__ = ["interaction_graph", "lm_train_batch", "lm_token_stream",
           "recsys_batch"]


def lm_train_batch(vocab: int, batch: int, seq: int, seed: int = 0,
                   device=None):
    """``tokens`` and ``labels`` (B, S) int32 (the labels are the tokens
    shifted by one), on ``device`` (None: the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {
        "tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
        "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev),
    }


def lm_token_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                    device=None):
    """Infinite deterministic token stream (for the train driver)."""
    step = 0
    while True:
        yield lm_train_batch(vocab, batch, seq, seed=seed + step,
                             device=device)
        step += 1


def recsys_batch(cfg, batch: int, seed: int = 0, with_logq: bool = True,
                 device=None):
    """A two-tower batch: ``user_ids`` (B, F_u, W), ``item_ids``
    (B, F_i, W) int32 and ``item_logq`` (B,) float32, from the reference's
    numpy draws (the same seed gives the same ids and ``item_logq``), as
    tensors on ``device`` (None: the card)."""
    dev = resolve_device(device)
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
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def interaction_graph(n_users: int, n_items: int, n_inter: int,
                      seed: int = 0) -> BipartiteGraph:
    """Bipartite user-item interaction graph — RECEIPT's input in the
    recsys integration (examples/recsys_tip_filtering_torch.py)."""
    return powerlaw_bipartite(n_users, n_items, n_inter, seed=seed)
