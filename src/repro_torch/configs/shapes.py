"""Assigned input-shape sets (public pool), one set per family (a copy
of ``repro.configs.shapes``, which imports no jax).

LM shapes: seq_len x global_batch; ``decode_*``/``long_*`` lower
``serve_step`` (one token against a seq_len KV cache).  GNN and recsys
shapes as assigned.  See DESIGN.md section 5 for the long_500k
(decode-is-linear) note.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LMShape:
    kind: str                  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


LM_SHAPES = {
    "train_4k": LMShape("train", 4_096, 256),
    "prefill_32k": LMShape("prefill", 32_768, 32),
    "decode_32k": LMShape("decode", 32_768, 128),
    "long_500k": LMShape("decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    kind: str                  # "full" | "minibatch" | "molecule"
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: Optional[int] = None
    batch_nodes: int = 0
    fanout: Tuple[int, int] = (0, 0)
    batch: int = 0
    triplet_fanout: int = 8    # capped triplets per edge (DimeNet large)


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full", n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    "minibatch_lg": GNNShape(
        "minibatch", n_nodes=232_965, n_edges=114_615_892,
        batch_nodes=1_024, fanout=(15, 10),
    ),
    "ogb_products": GNNShape(
        "full", n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
        triplet_fanout=2,   # DimeNet triplet cap at 62M edges (DESIGN.md)
    ),
    "molecule": GNNShape(
        "molecule", n_nodes=30, n_edges=64, batch=128, triplet_fanout=10
    ),
}


@dataclasses.dataclass(frozen=True)
class RecSysShape:
    kind: str                  # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecSysShape("train", 65_536),
    "serve_p99": RecSysShape("serve", 512),
    "serve_bulk": RecSysShape("serve", 262_144),
    "retrieval_cand": RecSysShape("retrieval", 1, n_candidates=1_000_000),
}


@dataclasses.dataclass(frozen=True)
class ReceiptShape:
    kind: str                  # "cd_sweep" | "fd_stack"
    n_u: int = 0
    n_v: int = 0
    peel_rows: int = 0
    n_subsets: int = 0
    subset_rows: int = 0
    subset_cols: int = 0


# Production-scale RECEIPT cells for the distributed dry-run: a CD peel
# sweep over a 1M x 256k dense-blocked residual graph (the paper's TrU is
# 27.7M x 12.8M but >99% of rows die in early subsets; 1M alive rows is
# the steady-state working set after DGM), and an FD stack of 512
# independent subsets.
RECEIPT_SHAPES = {
    "cd_sweep_1m": ReceiptShape("cd_sweep", n_u=1_048_576, n_v=262_144, peel_rows=65_536),
    "cd_recount_1m": ReceiptShape("cd_sweep", n_u=1_048_576, n_v=262_144, peel_rows=1_048_576),
    "fd_stack": ReceiptShape("fd_stack", n_subsets=512, subset_rows=2_048, subset_cols=8_192),
}
