"""Two-tower retrieval model (YouTube-style sampled-softmax retrieval,
Yi et al. RecSys'19; port of ``repro.models.recsys``).

The embedding bag is the reference's formulation: a row gather
(``F.embedding``) of the ids with -1 padding zeroed, then a sum or a mean
over the valid ones.  Its backward is a dense table-sized gradient (as the
reference's), which is what sizes a full-width step: parameters, two
AdamW moments and the gradients, 4 x the parameter bytes.

Shapes:
  * train_batch:    in-batch sampled softmax with logQ correction.
  * serve_p99/bulk: forward both towers, dot.
  * retrieval_cand: one query against n_candidates item embeddings
                    (batched dot, ``torch.topk``).

RECEIPT tie-in: the user-item interaction graph this model trains on is
bipartite; ``examples/recsys_tip_filtering_torch.py`` tip-decomposes a
fleet of cohort graphs with ``Executor.map`` and flags the collusive
users by tip number before training.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, init_mlp, mlp, randn, softmax_cross_entropy

__all__ = ["TwoTowerConfig", "TwoTower", "init_two_tower", "embedding_bag",
           "tower", "two_tower_embeddings", "sampled_softmax_loss",
           "retrieval_scores"]


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    interaction: str = "dot"
    # categorical fields: (vocab_size, avg multi-hot count) per tower
    user_fields: Tuple[int, ...] = (10_000_000, 1_000_000, 100_000, 1_000)
    item_fields: Tuple[int, ...] = (5_000_000, 500_000, 50_000, 1_000)
    values_per_field: int = 4          # fixed multi-hot width (padded)
    temperature: float = 0.05
    param_dtype: Any = torch.float32


class TwoTower(nn.Module):
    """The parameters: ``user_tables``/``item_tables`` (one (V, d) table
    per field) and ``user_mlp``/``item_mlp`` (``layers.MLP``)."""

    def __init__(self, cfg: TwoTowerConfig, user_tables, item_tables,
                 user_mlp: MLP, item_mlp: MLP):
        super().__init__()
        self.cfg = cfg
        self.user_tables = nn.ParameterList(
            [nn.Parameter(t) for t in user_tables])
        self.item_tables = nn.ParameterList(
            [nn.Parameter(t) for t in item_tables])
        self.user_mlp = user_mlp
        self.item_mlp = item_mlp


def init_two_tower(generator: Optional[torch.Generator],
                   cfg: TwoTowerConfig, *, device=None) -> TwoTower:
    """Tables N(0, 0.01^2) drawn in place on the generator's device, the
    MLPs as ``layers.init_mlp``; ``device="meta"`` allocates nothing."""
    d = cfg.embed_dim

    def table(v):
        return randn((v, d), generator, device).mul_(0.01).to(
            cfg.param_dtype)

    user = [table(v) for v in cfg.user_fields]
    item = [table(v) for v in cfg.item_fields]
    user_mlp = init_mlp(generator, [d * len(cfg.user_fields),
                                    *cfg.tower_mlp], cfg.param_dtype,
                        device=device)
    item_mlp = init_mlp(generator, [d * len(cfg.item_fields),
                                    *cfg.tower_mlp], cfg.param_dtype,
                        device=device)
    return TwoTower(cfg, user, item, user_mlp, item_mlp)


def embedding_bag(
    table: torch.Tensor,     # (V, d)
    ids: torch.Tensor,       # (B, W) int, -1 padded
    mode: str = "mean",
) -> torch.Tensor:
    """EmbeddingBag as a gather + masked reduce (sum, or the mean over the
    valid ids, at least one)."""
    valid = (ids >= 0)[..., None].to(table.dtype)
    emb = F.embedding(torch.clamp(ids, min=0), table) * valid
    s = emb.sum(dim=-2)
    if mode == "sum":
        return s
    return s / torch.clamp(valid.sum(dim=-2), min=1.0)


def tower(tables, mlp_params: MLP, field_ids: torch.Tensor) -> torch.Tensor:
    """field_ids: (B, n_fields, W).  Returns L2-normalized (B, d_out)."""
    embs = [embedding_bag(t, field_ids[:, i]) for i, t in enumerate(tables)]
    x = torch.cat(embs, dim=-1)
    x = mlp(mlp_params, x)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def two_tower_embeddings(p: TwoTower, batch, cfg: TwoTowerConfig):
    u = tower(p.user_tables, p.user_mlp, batch["user_ids"])
    v = tower(p.item_tables, p.item_mlp, batch["item_ids"])
    return u, v


def sampled_softmax_loss(p: TwoTower, batch, cfg: TwoTowerConfig
                         ) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction (Yi et al. '19).

    batch: user_ids (B, F, W), item_ids (B, F, W), item_logq (B,) log
    sampling probability of each in-batch negative.
    """
    u, v = two_tower_embeddings(p, batch, cfg)
    logits = (u @ v.T) / cfg.temperature                    # (B, B)
    logits = logits - batch["item_logq"][None, :]           # logQ correction
    labels = torch.arange(u.shape[0], device=u.device)
    return softmax_cross_entropy(logits, labels)


def retrieval_scores(
    p: TwoTower, query_ids: torch.Tensor, cand_emb: torch.Tensor,
    cfg: TwoTowerConfig, top_k: int = 100,
):
    """Score one (or few) queries against a precomputed candidate matrix.

    query_ids (B, F, W); cand_emb (n_candidates, d).  Brute-force batched
    dot + top-k (the retrieval_cand shape): (values, indices).
    """
    u = tower(p.user_tables, p.user_mlp, query_ids)        # (B, d)
    scores = u @ cand_emb.T                                  # (B, n_cand)
    return torch.topk(scores, top_k)
