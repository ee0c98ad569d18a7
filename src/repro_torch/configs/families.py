"""Family adapters: one Bundle per arch (port of
``repro.configs.families``, the surface training needs).

A Bundle wires a model config to what the launcher, the smoke run and
the tests need:

    bundle.abstract_params()             param module on the meta device
    bundle.init_params(generator)        real params on the generator's device
    bundle.state_abstract()              train state incl. optimizer, meta
    bundle.step_for(shape)               ("train"|"serve_*"|"retrieval", fn)
    bundle.input_specs(shape)            dict[str, ShapeDtype]
    bundle.input_shardings(shape, mesh)  matching NamedSharding tree
    bundle.param_shardings(mesh)         NamedSharding tree
    bundle.state_shardings(mesh)         the train state's, incl. optimizer

Shapes are the assigned public shape sets (``configs/shapes.py``); steps
are functions of (state|params, batch).  The sharding trees come from
``abstract_params()`` on the meta device (nothing is allocated) and the
rules of ``launch.sharding``; a ``DeviceMesh`` over meta devices
(``make_production_mesh(devices=[torch.device("meta")] * 256)``) gives
the production layouts without cards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..launch import sharding as shard_lib
from ..launch.mesh import NamedSharding, PartitionSpec, dp_axes
from ..models import gnn as gnn_lib
from ..models import recsys as rec_lib
from ..models import transformer as tf_lib
from ..train.optimizer import AdamWConfig
from ..train.train_step import init_train_state, make_train_step
from ..train.tree import keystr, map_with_paths
from . import shapes as shp

__all__ = ["ShapeDtype", "Bundle", "make_lm_bundle", "make_gnn_bundle",
           "make_recsys_bundle"]

_META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """The port's ``jax.ShapeDtypeStruct``: an input's shape and dtype."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass
class Bundle:
    arch_id: str
    family: str
    cfg: Any
    shapes: Dict[str, Any]
    opt_cfg: AdamWConfig
    _init_fn: Callable                          # (generator, device) -> params
    _steps: Dict[str, Callable]                 # step kind -> fn
    _specs_fn: Callable                         # (shape) -> (kind, specs)
    _input_shardings_fn: Callable               # (shape, mesh, specs) -> tree
    _param_shardings_fn: Callable               # (mesh, abstract) -> tree
    _loss_fn: Optional[Callable] = None         # (params, batch) -> (loss, metrics)

    # ---------------- params ---------------- #
    def abstract_params(self):
        return self._init_fn(None, _META)

    def init_params(self, generator: Optional[torch.Generator] = None, *,
                    device=None):
        """Params drawn from ``generator`` on ``device``, else on the
        generator's device, else on the card (raising without one)."""
        return self._init_fn(generator, device)

    def param_shardings(self, mesh):
        return self._param_shardings_fn(mesh, self.abstract_params())

    # ---------------- train state ------------ #
    def state_abstract(self):
        return init_train_state(self.abstract_params(), self.opt_cfg)

    def state_shardings(self, mesh):
        return shard_lib.train_state_specs(self.param_shardings(mesh))

    # ---------------- steps ------------------ #
    def step_for(self, shape_name: str) -> Tuple[str, Callable]:
        kind, _ = self._specs_fn(shape_name)
        return kind, self._steps[kind]

    def input_specs(self, shape_name: str) -> Dict[str, ShapeDtype]:
        _, specs = self._specs_fn(shape_name)
        return specs

    def input_shardings(self, shape_name: str, mesh):
        _, specs = self._specs_fn(shape_name)
        return self._input_shardings_fn(shape_name, mesh, specs)


# ===================================================================== #
# LM family
# ===================================================================== #
def _sds_tree(tree):
    return {k: (ShapeDtype((), torch.int32) if not torch.is_tensor(v)
                else ShapeDtype(tuple(v.shape), v.dtype))
            for k, v in tree.items()}


def _lm_specs(cfg: tf_lib.LMConfig, shapes, shape_name):
    s = shapes[shape_name]
    i32 = torch.int32
    if s.kind == "train":
        return "train", {
            "tokens": ShapeDtype((s.global_batch, s.seq_len), i32),
            "labels": ShapeDtype((s.global_batch, s.seq_len), i32),
        }
    if s.kind == "prefill":
        return "serve_prefill", {
            "tokens": ShapeDtype((s.global_batch, s.seq_len), i32),
        }
    # decode: one new token against a seq_len KV cache (its shapes from
    # init_cache on the meta device; ``len`` an int32 scalar)
    cache = tf_lib.init_cache(cfg, s.global_batch, s.seq_len, device=_META)
    return "serve_decode", {
        "token": ShapeDtype((s.global_batch,), i32),
        "cache": _sds_tree(cache),
    }


def _lm_input_shardings(cfg, shapes, shape_name, mesh, specs):
    s = shapes[shape_name]
    dp = dp_axes(mesh)
    out = {}
    for k, v in specs.items():
        if k in ("tokens", "labels"):
            out[k] = shard_lib.simple_spec(mesh, (dp, None), v.shape)
        elif k == "token":
            out[k] = shard_lib.simple_spec(mesh, (dp,), v.shape)
        elif k == "cache":
            # batch over dp, seq over model; for batch=1 (long_500k) the
            # dp axes are idle, so the KV sequence splits over ALL axes
            # instead (flash-decoding-style split-KV)
            seq_ax = ("pod", "data", "model") if s.global_batch == 1 \
                else "model"
            b_ax = None if s.global_batch == 1 else dp

            def cspec(path, leaf):
                if len(leaf.shape) == 0:
                    return NamedSharding(mesh, PartitionSpec())
                if path[-1] in ("c_kv", "k_rope"):
                    ent = (None, b_ax, seq_ax, None)        # (L, B, S, r)
                else:
                    ent = (None, b_ax, None, seq_ax, None)  # (L, B, H, S, D)
                return NamedSharding(
                    mesh, shard_lib._check_div(leaf.shape, ent, mesh))

            out[k] = map_with_paths(cspec, v)
    return out


def make_lm_bundle(arch_id: str, cfg: tf_lib.LMConfig,
                   opt_cfg: Optional[AdamWConfig] = None, *,
                   shapes: Optional[Dict[str, shp.LMShape]] = None) -> Bundle:
    """The LM bundle over the assigned shapes, or over ``shapes`` (a
    caller's own ``LMShape`` set, as the dry run's calibration uses)."""
    opt_cfg = opt_cfg or AdamWConfig()
    shapes = shp.LM_SHAPES if shapes is None else shapes

    def loss_fn(params, batch):
        return tf_lib.lm_loss(params, batch, cfg)

    def serve_prefill(params, batch):
        return tf_lib.lm_prefill(params, batch["tokens"], cfg)

    def serve_decode(params, batch):
        return tf_lib.lm_decode_step(params, batch["cache"], batch["token"],
                                     cfg)

    return Bundle(
        arch_id=arch_id,
        family="lm",
        cfg=cfg,
        shapes=shapes,
        opt_cfg=opt_cfg,
        _loss_fn=loss_fn,
        _init_fn=lambda gen, device: tf_lib.init_lm(gen, cfg, device=device),
        _steps={
            "train": make_train_step(loss_fn, opt_cfg),
            "serve_prefill": serve_prefill,
            "serve_decode": serve_decode,
        },
        _specs_fn=lambda sn: _lm_specs(cfg, shapes, sn),
        _input_shardings_fn=lambda sn, mesh, specs: _lm_input_shardings(
            cfg, shapes, sn, mesh, specs),
        _param_shardings_fn=lambda mesh, ab: shard_lib.lm_param_specs(
            ab, mesh),
    )


# ===================================================================== #
# GNN family
# ===================================================================== #
def _round_up(n, m=8):
    return ((n + m - 1) // m) * m


def _gnn_graph_dims(shape) -> Tuple[int, int]:
    """(n_nodes, n_edges) for the generic subgraph view of a shape."""
    if shape.kind == "minibatch":
        f1, f2 = shape.fanout
        n = shape.batch_nodes * (1 + f1 + f1 * f2)
        e = shape.batch_nodes * (f1 + f1 * f2)
        return _round_up(n, 128), _round_up(e, 128)
    if shape.kind == "molecule":
        return shape.batch * shape.n_nodes, shape.batch * shape.n_edges
    return _round_up(shape.n_nodes, 128), _round_up(shape.n_edges, 128)


def _gnn_specs(arch_id, cfg, shapes, shape_name):
    s = shapes[shape_name]
    f32, i32 = torch.float32, torch.int32
    SD = ShapeDtype

    if arch_id == "graphsage-reddit" and s.kind == "minibatch":
        # native sampled-block structure
        f1, f2 = s.fanout
        b = s.batch_nodes
        d = cfg.d_in
        specs = {
            "feats_l0": SD((b, d), f32),
            "feats_l1": SD((b * f1, d), f32),
            "feats_l2": SD((b * f1 * f2, d), f32),
            "idx_l0": SD((b, f1), i32),
            "idx_l1": SD((b * f1, f2), i32),
            "labels": SD((b,), i32),
        }
        return "train_sampled", specs

    n, e = _gnn_graph_dims(s)
    base = {
        "senders": SD((e,), i32),
        "receivers": SD((e,), i32),
        "edge_mask": SD((e,), f32),
    }
    if arch_id == "meshgraphnet":
        specs = dict(base)
        specs["node_feats"] = SD((n, cfg.d_node_in), f32)
        specs["edge_feats"] = SD((e, cfg.d_edge_in), f32)
        specs["targets"] = SD((n, cfg.d_out), f32)
        return "train", specs
    if arch_id == "graphsage-reddit":
        specs = dict(base)
        specs["node_feats"] = SD((n, cfg.d_in), f32)
        specs["labels"] = SD((n,), i32)
        specs["node_mask"] = SD((n,), f32)
        return "train", specs
    if arch_id == "dimenet":
        t = _round_up(e * s.triplet_fanout, 128)
        specs = dict(base)
        specs["node_feats"] = SD((n, cfg.d_node_in), f32)
        specs["positions"] = SD((n, 3), f32)
        specs["trip_kj"] = SD((t,), i32)
        specs["trip_ji"] = SD((t,), i32)
        specs["trip_mask"] = SD((t,), f32)
        if s.kind == "molecule":
            specs["graph_id"] = SD((n,), i32)
            specs["targets"] = SD((s.batch,), f32)
        else:
            specs["targets"] = SD((1,), f32)
        return "train", specs
    if arch_id == "graphcast":
        nm = cfg.n_mesh_nodes_padded
        em = cfg.n_mesh_edges_padded
        e_g2m, e_m2g = 4 * n, 3 * n
        specs = {
            "grid_feats": SD((n, cfg.n_vars), f32),
            "mesh_feats": SD((nm, 4), f32),
            "g2m_senders": SD((e_g2m,), i32),
            "g2m_receivers": SD((e_g2m,), i32),
            "g2m_feats": SD((e_g2m, 4), f32),
            "g2m_mask": SD((e_g2m,), f32),
            "mesh_senders": SD((em,), i32),
            "mesh_receivers": SD((em,), i32),
            "mesh_efeats": SD((em, 4), f32),
            "mesh_mask": SD((em,), f32),
            "m2g_senders": SD((e_m2g,), i32),
            "m2g_receivers": SD((e_m2g,), i32),
            "m2g_feats": SD((e_m2g, 4), f32),
            "m2g_mask": SD((e_m2g,), f32),
            "targets": SD((n, cfg.n_vars), f32),
        }
        return "train", specs
    raise KeyError(arch_id)


_GNN_NODE_KEYS = (
    "node_feats", "grid_feats", "mesh_feats", "positions", "labels",
    "targets", "node_mask", "graph_id", "feats_l",
)


def _gnn_input_shardings(shape_name, mesh, specs):
    """Node-dim arrays shard over `model`; edge/triplet arrays over dp
    (matching the logical activation axes of ``launch.sharding``)."""
    dp = dp_axes(mesh)

    def assign(path, leaf):
        if len(leaf.shape) == 0:
            return NamedSharding(mesh, PartitionSpec())
        key = shard_lib.norm_path(path)
        axis = "model" if any(k in key for k in _GNN_NODE_KEYS) else dp
        ent = [axis] + [None] * (len(leaf.shape) - 1)
        return NamedSharding(mesh, shard_lib._check_div(leaf.shape, ent,
                                                        mesh))

    return map_with_paths(assign, specs)


def _replicated(mesh, abstract):
    return map_with_paths(
        lambda _, __: NamedSharding(mesh, PartitionSpec()), abstract)


_GNN_MODELS = {
    # arch -> (init, loss of (params, batch, cfg))
    "meshgraphnet": (gnn_lib.init_meshgraphnet, gnn_lib.meshgraphnet_loss),
    "graphsage-reddit": (gnn_lib.init_graphsage, gnn_lib.graphsage_loss),
    "dimenet": (gnn_lib.init_dimenet, gnn_lib.dimenet_loss),
    "graphcast": (gnn_lib.init_graphcast, gnn_lib.graphcast_loss),
}


def make_gnn_bundle(arch_id: str, cfg,
                    opt_cfg: Optional[AdamWConfig] = None) -> Bundle:
    """The GNN bundle: ``train`` (the full-graph / batched loss) and
    ``train_sampled`` (GraphSAGE's sampled blocks; the other archs' loss
    again)."""
    opt_cfg = opt_cfg or AdamWConfig()
    shapes = shp.GNN_SHAPES
    if arch_id not in _GNN_MODELS:
        raise KeyError(arch_id)
    init, loss_of = _GNN_MODELS[arch_id]

    def loss(p, b):
        return loss_of(p, b, cfg), {}

    loss_sampled = loss
    if arch_id == "graphsage-reddit":
        def loss_sampled(p, b):
            return gnn_lib.graphsage_loss(p, b, cfg, mode="sampled"), {}

    return Bundle(
        arch_id=arch_id,
        family="gnn",
        cfg=cfg,
        shapes=shapes,
        opt_cfg=opt_cfg,
        _loss_fn=loss,
        _init_fn=lambda gen, device: init(gen, cfg, device=device),
        _steps={
            "train": make_train_step(loss, opt_cfg),
            "train_sampled": make_train_step(loss_sampled, opt_cfg),
        },
        _specs_fn=lambda sn: _gnn_specs(arch_id, cfg, shapes, sn),
        _input_shardings_fn=lambda sn, mesh, specs: _gnn_input_shardings(
            sn, mesh, specs),
        # d_hidden 128-512 is too small to TP profitably: replicated
        _param_shardings_fn=_replicated,
    )


# ===================================================================== #
# recsys family
# ===================================================================== #
def _rec_specs(cfg: rec_lib.TwoTowerConfig, shapes, shape_name):
    s = shapes[shape_name]
    i32, f32 = torch.int32, torch.float32
    fu, fi = len(cfg.user_fields), len(cfg.item_fields)
    w = cfg.values_per_field
    if s.kind == "train":
        return "train", {
            "user_ids": ShapeDtype((s.batch, fu, w), i32),
            "item_ids": ShapeDtype((s.batch, fi, w), i32),
            "item_logq": ShapeDtype((s.batch,), f32),
        }
    if s.kind == "serve":
        return "serve", {
            "user_ids": ShapeDtype((s.batch, fu, w), i32),
            "item_ids": ShapeDtype((s.batch, fi, w), i32),
        }
    # retrieval: one query batch vs n_candidates
    return "retrieval", {
        "user_ids": ShapeDtype((s.batch, fu, w), i32),
        "cand_emb": ShapeDtype((s.n_candidates, cfg.tower_mlp[-1]), f32),
    }


def _rec_input_shardings(shape_name, mesh, specs):
    dp = dp_axes(mesh)

    def assign(path, leaf):
        if "cand_emb" in keystr(path):
            ent = ("model", None)
        else:
            ent = [dp] + [None] * (len(leaf.shape) - 1)
        return NamedSharding(mesh, shard_lib._check_div(leaf.shape, ent,
                                                        mesh))

    return map_with_paths(assign, specs)


def _rec_param_shardings(mesh, abstract):
    def assign(path, leaf):
        if "tables" in keystr(path):
            return NamedSharding(mesh, shard_lib._check_div(
                tuple(leaf.shape), ("model", None), mesh))
        return NamedSharding(mesh, PartitionSpec())

    return map_with_paths(assign, abstract)


def make_recsys_bundle(arch_id: str, cfg: rec_lib.TwoTowerConfig,
                       opt_cfg: Optional[AdamWConfig] = None) -> Bundle:
    opt_cfg = opt_cfg or AdamWConfig()
    shapes = shp.RECSYS_SHAPES

    def loss(p, b):
        return rec_lib.sampled_softmax_loss(p, b, cfg), {}

    @torch.no_grad()
    def serve(params, batch):
        u, v = rec_lib.two_tower_embeddings(params, batch, cfg)
        return torch.sum(u * v, dim=-1)

    @torch.no_grad()
    def retrieval(params, batch):
        return rec_lib.retrieval_scores(
            params, batch["user_ids"], batch["cand_emb"], cfg)

    return Bundle(
        arch_id=arch_id,
        family="recsys",
        cfg=cfg,
        shapes=shapes,
        opt_cfg=opt_cfg,
        _loss_fn=loss,
        _init_fn=lambda gen, device: rec_lib.init_two_tower(
            gen, cfg, device=device),
        _steps={
            "train": make_train_step(loss, opt_cfg),
            "serve": serve,
            "retrieval": retrieval,
        },
        _specs_fn=lambda sn: _rec_specs(cfg, shapes, sn),
        _input_shardings_fn=lambda sn, mesh, specs: _rec_input_shardings(
            sn, mesh, specs),
        _param_shardings_fn=_rec_param_shardings,
    )
