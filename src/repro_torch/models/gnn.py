"""GNN model zoo: MeshGraphNet, GraphSAGE, DimeNet, GraphCast (port of
``repro.models.gnn``).

All message passing runs on a segment scatter-add over edge index arrays
(``seg_sum``: ``index_add`` into zeros), the reference's
``jax.ops.segment_sum``.  ``segment_sum`` drops out-of-range ids where
``index_add`` asserts on them, so every caller keeps the reference's clamps
(``jnp.maximum(ji, 0)`` and the like) and builds its ids in range.  On the
card the scatter adds in no fixed order: results there are within
tolerance of the CPU's, not bit-equal.

Graph batches are fixed-shape: (node_feats (N, F), senders (E,),
receivers (E,), edge_feats (E, Fe)) with -1/0-padded edges masked by
``edge_mask``.  Mixed dtypes follow JAX's promotion: a bfloat16 carry
against float32 params or masks computes in float32 (``layers.matmul``,
``torch.cat`` and the elementwise ops promote alike), and the carry is
cast back where the reference casts it.  The reference's three
``jax.checkpoint`` sites are ``layers.remat``.

Params are ``nn.Module`` trees (``ParamTree``) whose parameter names are
the reference's tree paths: ``layers.0.edge_mlp.layers.1.w``,
``blocks.3.bilinear``, ``processor.15.node_mlp.layers.0.b``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..launch.sharding import shard_act
from .layers import (dense_init, draw, init_device, init_layernorm, init_mlp,
                     layernorm, matmul, mlp, remat, softmax_cross_entropy)

__all__ = ["ParamTree", "rows", "seg_sum", "seg_mean", "l2_normalize",
           "MeshGraphNetConfig", "init_meshgraphnet", "meshgraphnet_forward",
           "meshgraphnet_loss", "GraphSAGEConfig", "init_graphsage",
           "graphsage_forward_full", "graphsage_forward_sampled",
           "graphsage_loss", "DimeNetConfig", "init_dimenet",
           "dimenet_forward", "dimenet_loss", "GraphCastConfig",
           "init_graphcast", "graphcast_forward", "graphcast_loss"]


class ParamTree(nn.Module):
    """A node of a param tree: each keyword a child, a tensor as a
    parameter, a list as an ``nn.ModuleList``, a module as itself (the
    reference's dicts and lists of params, under the same names)."""

    def __init__(self, **children):
        super().__init__()
        for name, v in children.items():
            if isinstance(v, torch.Tensor):
                v = nn.Parameter(v)
            elif isinstance(v, (list, tuple)):
                v = nn.ModuleList(v)
            setattr(self, name, v)


def rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for int64 ids of any shape, as ``index_select``: its
    backward is an ``index_add`` (``x[idx]``'s sorts the ids first, which
    took 264 of DimeNet's 293 device ms a step on the card at 81,920
    triplets into 8,192 edges)."""
    return torch.index_select(x, 0, idx.reshape(-1)).reshape(
        *idx.shape, *x.shape[1:])


def seg_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of ``x`` summed into ``n`` segments by ``idx`` (every id in
    [0, n)), in ``x``'s dtype."""
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add(0, idx.long(), x)


def seg_mean(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    s = seg_sum(x, idx, n)
    c = seg_sum(torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device),
                idx, n)
    return s / torch.clamp(c, min=1.0)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The L2 norm over the last axis as ``sqrt(sum(x * x))``, which is
    how ``jnp.linalg.norm`` computes it, gradient included (NaN at an
    all-zero row; ``torch.linalg.norm``'s is finite there)."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def l2_normalize(h: torch.Tensor) -> torch.Tensor:
    """GraphSAGE's row normalization: ``h / max(||h||, 1e-6)``."""
    return h / torch.clamp(_norm(h), min=1e-6)


# ===================================================================== #
# MeshGraphNet  [arXiv:2010.03409]
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 16
    d_edge_in: int = 8
    d_out: int = 3
    aggregator: str = "sum"
    param_dtype: Any = torch.float32
    carry_dtype: Any = torch.float32   # bf16 at production scale


def _mgn_mlp_dims(d_in, d_h, n_hidden, d_out):
    return [d_in] + [d_h] * n_hidden + [d_out]


def init_meshgraphnet(generator: Optional[torch.Generator],
                      cfg: MeshGraphNetConfig, *, device=None) -> ParamTree:
    dev = init_device(device, generator)
    d, dt = cfg.d_hidden, cfg.param_dtype

    def m(dims):
        return init_mlp(generator, dims, dt, device=dev)

    node_enc = m(_mgn_mlp_dims(cfg.d_node_in, d, cfg.mlp_layers, d))
    edge_enc = m(_mgn_mlp_dims(cfg.d_edge_in, d, cfg.mlp_layers, d))
    decoder = m(_mgn_mlp_dims(d, d, cfg.mlp_layers, cfg.d_out))
    layers = [ParamTree(
        edge_mlp=m(_mgn_mlp_dims(3 * d, d, cfg.mlp_layers, d)),
        edge_ln=init_layernorm(d, dt, device=dev),
        node_mlp=m(_mgn_mlp_dims(2 * d, d, cfg.mlp_layers, d)),
        node_ln=init_layernorm(d, dt, device=dev),
    ) for _ in range(cfg.n_layers)]
    return ParamTree(node_enc=node_enc, edge_enc=edge_enc, decoder=decoder,
                     layers=layers)


def _mgn_layer(lp, h, e, snd, rcv, emask, n, carry_dtype):
    # edge update from (e, h_src, h_dst), residual + LN
    e_in = torch.cat([e, rows(h, snd), rows(h, rcv)], dim=-1)
    e = layernorm(lp.edge_ln, e + mlp(lp.edge_mlp, e_in) * emask)
    # node update from aggregated incoming messages, residual + LN
    agg = seg_sum(e * emask, rcv, n)
    h_in = torch.cat([h, agg], dim=-1)
    h = layernorm(lp.node_ln, h + mlp(lp.node_mlp, h_in))
    # carries stay in carry_dtype between layers (what remat saves)
    return (shard_act(h.to(carry_dtype), ("nodes", None)),
            shard_act(e.to(carry_dtype), ("edges", None)))


def meshgraphnet_forward(p: ParamTree, batch: Dict[str, torch.Tensor],
                         cfg: MeshGraphNetConfig) -> torch.Tensor:
    """batch: node_feats (N,Fn), edge_feats (E,Fe), senders/receivers (E,),
    edge_mask (E,).  Returns per-node output (N, d_out)."""
    n = batch["node_feats"].shape[0]
    snd, rcv = batch["senders"].long(), batch["receivers"].long()
    emask = batch["edge_mask"][:, None].to(cfg.param_dtype)
    h = mlp(p.node_enc, batch["node_feats"]).to(cfg.carry_dtype)
    e = (mlp(p.edge_enc, batch["edge_feats"]) * emask).to(cfg.carry_dtype)
    for lp in p.layers:
        h, e = remat(_mgn_layer, lp, h, e, snd, rcv, emask, n,
                     cfg.carry_dtype)
    return mlp(p.decoder, h)


def meshgraphnet_loss(p, batch, cfg) -> torch.Tensor:
    pred = meshgraphnet_forward(p, batch, cfg)
    mask = batch.get("node_mask")
    err = (pred - batch["targets"]) ** 2
    if mask is not None:
        return torch.sum(err * mask[:, None]) / torch.clamp(
            torch.sum(mask) * err.shape[-1], min=1.0)
    return torch.mean(err)


# ===================================================================== #
# GraphSAGE  [arXiv:1706.02216]
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    aggregator: str = "mean"
    sample_sizes: Tuple[int, ...] = (25, 10)
    param_dtype: Any = torch.float32


def init_graphsage(generator: Optional[torch.Generator],
                   cfg: GraphSAGEConfig, *, device=None) -> ParamTree:
    dev = init_device(device, generator)
    dt = cfg.param_dtype
    layers = []
    d_prev = cfg.d_in
    for _ in range(cfg.n_layers):
        layers.append(ParamTree(
            w_self=dense_init(generator, d_prev, cfg.d_hidden, dt,
                              device=dev),
            w_neigh=dense_init(generator, d_prev, cfg.d_hidden, dt,
                               device=dev),
        ))
        d_prev = cfg.d_hidden
    return ParamTree(layers=layers,
                     head=dense_init(generator, d_prev, cfg.n_classes, dt,
                                     device=dev))


def graphsage_forward_full(p: ParamTree, batch, cfg: GraphSAGEConfig):
    """Full-graph mode: mean-aggregate over the edge list."""
    h = batch["node_feats"]
    n = h.shape[0]
    snd, rcv = batch["senders"].long(), batch["receivers"].long()
    emask = batch["edge_mask"][:, None].to(h.dtype)
    for lp in p.layers:
        neigh = seg_mean(rows(h, snd) * emask, rcv, n)
        h = torch.relu(matmul(h, lp.w_self) + matmul(neigh, lp.w_neigh))
        h = shard_act(l2_normalize(h), ("nodes", None))
    return matmul(h, p.head)


def graphsage_forward_sampled(p: ParamTree, batch, cfg: GraphSAGEConfig):
    """Minibatch mode on a sampled block structure (models/sampler.py).

    batch: feats_l{i} (Ni, F) node features per hop level (level 0 =
    seeds), idx_l{i} (N_{i-1}, fanout_{i-1}) int32 indices into level i
    (-1 = missing neighbour).  Aggregation runs top-down.
    """
    n_layers = cfg.n_layers
    hs = [batch[f"feats_l{i}"] for i in range(n_layers + 1)]
    for li, lp in enumerate(p.layers):
        # standard layerwise block computation: after layer li only the
        # first (n_layers - li) levels are still needed
        new_hs = []
        for lvl in range(n_layers - li):
            idx = batch[f"idx_l{lvl}"]           # (N_lvl, fanout) -> level lvl+1
            child = hs[lvl + 1]
            valid = (idx >= 0)[..., None].to(child.dtype)
            gathered = rows(child, torch.clamp(idx, min=0).long()) * valid
            neigh = gathered.sum(1) / torch.clamp(valid.sum(1), min=1.0)
            h = torch.relu(matmul(hs[lvl], lp.w_self)
                           + matmul(neigh, lp.w_neigh))
            new_hs.append(l2_normalize(h))
        hs = new_hs
    return matmul(hs[0], p.head)


def graphsage_loss(p, batch, cfg, mode="full"):
    if mode == "full":
        logits = graphsage_forward_full(p, batch, cfg)
    else:
        logits = graphsage_forward_sampled(p, batch, cfg)
    return softmax_cross_entropy(logits, batch["labels"],
                                 batch.get("node_mask"))


# ===================================================================== #
# DimeNet  [arXiv:2003.03123]
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_node_in: int = 16
    cutoff: float = 5.0
    param_dtype: Any = torch.float32
    carry_dtype: Any = torch.float32


def init_dimenet(generator: Optional[torch.Generator], cfg: DimeNetConfig,
                 *, device=None) -> ParamTree:
    dev = init_device(device, generator)
    d, dt = cfg.d_hidden, cfg.param_dtype

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, dt, device=dev)

    def m(dims):
        return init_mlp(generator, dims, dt, device=dev)

    node_embed = dense(cfg.d_node_in, d)
    rbf_embed = dense(cfg.n_radial, d)
    edge_embed = m([3 * d, d])
    out_head = m([d, d, 1])
    blocks = [ParamTree(
        w_sbf=dense(cfg.n_spherical * cfg.n_radial, cfg.n_bilinear),
        w_kj=dense(d, d),
        bilinear=draw((d, cfg.n_bilinear, d), 1.0 / math.sqrt(d), dt,
                      generator, dev),
        mlp_msg=m([d, d]),
        out_mlp=m([d, d]),
    ) for _ in range(cfg.n_blocks)]
    return ParamTree(node_embed=node_embed, rbf_embed=rbf_embed,
                     edge_embed=edge_embed, out_head=out_head, blocks=blocks)


def _rbf(d, n_radial, cutoff):
    """Radial basis: sin(n pi d / c) / d envelope (DimeNet eq. 6)."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    d = torch.clamp(d[:, None], min=1e-6)
    return torch.sin(n * math.pi * d / cutoff) / d


def _sbf(angle, d, n_spherical, n_radial, cutoff):
    """Simplified spherical basis: cos(l * angle) x radial sin modes."""
    l = torch.arange(n_spherical, dtype=torch.float32, device=angle.device)
    ang = torch.cos(l * angle[:, None])                     # (T, L)
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    dd = torch.clamp(d[:, None], min=1e-6)
    rad = torch.sin(n * math.pi * dd / cutoff) / dd         # (T, R)
    return (ang[:, :, None] * rad[:, None, :]).reshape(angle.shape[0], -1)


def _bilinear(a, w, mk):
    """``einsum("tb,dbe,td->te", a, w, mk)`` contracted as ``mk @ w``
    first: a (T, d, n_bilinear, d) intermediate would not fit at T =
    81,920, the (T, n_bilinear * d) one does."""
    d, nb, e = w.shape
    t = matmul(mk, w.reshape(d, nb * e)).reshape(-1, nb, e)
    return torch.bmm(a[:, None, :], t)[:, 0]


def _dimenet_block(bp, m, out, sbf, kj, ji, tmask, emask, rcv, n, out_head,
                   carry_dtype):
    # directional message passing over triplets (kj -> ji)
    n_edges = m.shape[0]
    a = matmul(sbf, bp.w_sbf)                               # (T, n_bilinear)
    mk = rows(matmul(m, bp.w_kj), kj)                       # (T, d)
    mk = shard_act(mk, ("edges", None))
    inter = _bilinear(a, bp.bilinear, mk)
    inter = shard_act(inter * tmask[:, None], ("edges", None))
    m = m + mlp(bp.mlp_msg, seg_sum(inter, ji, n_edges)).to(carry_dtype)
    m = shard_act(m * emask[:, None].to(carry_dtype), ("edges", None))
    # per-block output: edges -> receiver nodes -> scalar head
    node_contrib = seg_sum(mlp(bp.out_mlp, m) * emask[:, None], rcv, n)
    out = out + mlp(out_head, node_contrib)[:, 0]
    return m, out


def dimenet_forward(p: ParamTree, batch, cfg: DimeNetConfig,
                    n_graphs: Optional[int] = None) -> torch.Tensor:
    """batch: node_feats (N,F), positions (N,3), senders/receivers (E,),
    edge_mask (E,), trip_kj/trip_ji (T,) edge-index pairs, trip_mask (T,).
    Returns per-graph scalars when (graph_id, n_graphs) are provided,
    else the whole-graph scalar."""
    n = batch["node_feats"].shape[0]
    snd, rcv = batch["senders"].long(), batch["receivers"].long()
    pos = batch["positions"]
    emask = batch["edge_mask"].to(cfg.param_dtype)

    vec = rows(pos, rcv) - rows(pos, snd)
    dist = _norm(vec)[:, 0] + 1e-9
    rbf = matmul(_rbf(dist, cfg.n_radial, cfg.cutoff), p.rbf_embed)

    h = shard_act(matmul(batch["node_feats"], p.node_embed), ("nodes", None))
    m = mlp(p.edge_embed, torch.cat([rows(h, snd), rows(h, rcv), rbf], -1))
    m = shard_act((m * emask[:, None]).to(cfg.carry_dtype), ("edges", None))

    kj = torch.clamp(batch["trip_kj"], min=0).long()
    ji = torch.clamp(batch["trip_ji"], min=0).long()
    tmask = batch["trip_mask"].to(cfg.param_dtype)
    # angle between edge kj and ji (sharing node j)
    v1, v2 = rows(vec, kj), rows(vec, ji)
    cosang = torch.sum(v1 * v2, -1) / (_norm(v1)[:, 0] * _norm(v2)[:, 0]
                                       + 1e-9)
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = _sbf(angle, rows(dist, kj), cfg.n_spherical, cfg.n_radial,
               cfg.cutoff)

    out = torch.zeros((n,), dtype=cfg.param_dtype, device=m.device)
    for bp in p.blocks:
        m, out = remat(_dimenet_block, bp, m, out, sbf, kj, ji, tmask, emask,
                       rcv, n, p.out_head, cfg.carry_dtype)
    if "graph_id" in batch and n_graphs is not None:
        return seg_sum(out, batch["graph_id"], n_graphs)
    return out.sum()[None]


def dimenet_loss(p, batch, cfg):
    # n_graphs is static: the per-graph target vector length
    n_graphs = batch["targets"].shape[0] if "graph_id" in batch else None
    pred = dimenet_forward(p, batch, cfg, n_graphs=n_graphs)
    return torch.mean((pred - batch["targets"]) ** 2)


# ===================================================================== #
# GraphCast  [arXiv:2212.12794]
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    mesh_refinement: int = 6
    n_vars: int = 227
    mlp_layers: int = 1
    param_dtype: Any = torch.float32
    carry_dtype: Any = torch.float32

    @property
    def n_mesh_nodes(self) -> int:
        # icosahedral refinement: 10 * 4^r + 2
        return 10 * 4**self.mesh_refinement + 2

    @property
    def n_mesh_edges(self) -> int:
        # multimesh: edges of all refinement levels 0..r (30 * 4^l each)
        return sum(30 * 4**l for l in range(self.mesh_refinement + 1))

    @property
    def n_mesh_nodes_padded(self) -> int:
        # padded to 1024 so the mesh-node dim shards evenly over dp axes
        return ((self.n_mesh_nodes + 1023) // 1024) * 1024

    @property
    def n_mesh_edges_padded(self) -> int:
        return ((self.n_mesh_edges + 1023) // 1024) * 1024


def _typed_mpnn_init(generator, d, d_edge_in, mlp_layers, dtype, dev):
    def m(dims):
        return init_mlp(generator, dims, dtype, device=dev)

    return ParamTree(
        edge_enc=m([d_edge_in] + [d] * mlp_layers + [d]),
        edge_mlp=m([3 * d] + [d] * mlp_layers + [d]),
        node_mlp=m([2 * d] + [d] * mlp_layers + [d]),
    )


def init_graphcast(generator: Optional[torch.Generator],
                   cfg: GraphCastConfig, *, device=None) -> ParamTree:
    dev = init_device(device, generator)
    d, dt = cfg.d_hidden, cfg.param_dtype
    return ParamTree(
        grid_enc=init_mlp(generator, [cfg.n_vars, d, d], dt, device=dev),
        mesh_embed=init_mlp(generator, [4, d, d], dt, device=dev),
        g2m=_typed_mpnn_init(generator, d, 4, cfg.mlp_layers, dt, dev),
        m2g=_typed_mpnn_init(generator, d, 4, cfg.mlp_layers, dt, dev),
        decoder=init_mlp(generator, [d, d, cfg.n_vars], dt, device=dev),
        processor=[_typed_mpnn_init(generator, d, 4, cfg.mlp_layers, dt, dev)
                   for _ in range(cfg.n_layers)],
    )


def _mpnn_step(lp, h_src, h_dst, e_feat, snd, rcv, n_dst, emask):
    e = mlp(lp.edge_enc, e_feat) * emask
    msg_in = torch.cat([e, rows(h_src, snd), rows(h_dst, rcv)], -1)
    msg = mlp(lp.edge_mlp, msg_in) * emask
    agg = seg_sum(msg, rcv, n_dst)
    return h_dst + mlp(lp.node_mlp, torch.cat([h_dst, agg], -1))


def _graphcast_proc_layer(lp, hm, e_feat, snd, rcv, nm, emask, carry_dtype):
    hm = _mpnn_step(lp, hm, hm, e_feat, snd, rcv, nm, emask)
    return shard_act(hm.to(carry_dtype), ("nodes", None))


def graphcast_forward(p: ParamTree, batch, cfg: GraphCastConfig
                      ) -> torch.Tensor:
    """Encode (grid->mesh) / process (mesh multimesh) / decode (mesh->grid).

    batch: grid_feats (Ng, n_vars); mesh_feats (Nm, 4);
    g2m/m2g/mesh edge index + feature arrays (fixed shapes).
    """
    ng = batch["grid_feats"].shape[0]
    nm = batch["mesh_feats"].shape[0]
    hg = mlp(p.grid_enc, batch["grid_feats"])
    hm = mlp(p.mesh_embed, batch["mesh_feats"])

    def edges(kind):
        return (batch[f"{kind}_senders"].long(),
                batch[f"{kind}_receivers"].long(),
                batch[f"{kind}_mask"][:, None].to(hg.dtype))

    snd, rcv, m1 = edges("g2m")
    hm = _mpnn_step(p.g2m, hg, hm, batch["g2m_feats"], snd, rcv, nm, m1)
    snd, rcv, m2 = edges("mesh")
    for lp in p.processor:
        hm = remat(_graphcast_proc_layer, lp, hm, batch["mesh_efeats"], snd,
                   rcv, nm, m2, cfg.carry_dtype)
    snd, rcv, m3 = edges("m2g")
    hg = _mpnn_step(p.m2g, hm, hg, batch["m2g_feats"], snd, rcv, ng, m3)
    return mlp(p.decoder, hg)


def graphcast_loss(p, batch, cfg):
    pred = graphcast_forward(p, batch, cfg)
    return torch.mean((pred - batch["targets"]) ** 2)
