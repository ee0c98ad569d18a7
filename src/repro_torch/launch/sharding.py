"""Rule-based PartitionSpec assignment (port of
``repro.launch.sharding``).

Models are mesh-agnostic; this module maps parameter / input trees to
``NamedSharding``s via path-regex rules, per family:

  LM    : TP over ``model`` on head/ffn dims, EP over ``model`` on the
          expert dim, FSDP over ``(pod, data)`` on d_model dims, vocab
          over ``model``; batch over ``(pod, data)``.
  GNN   : node arrays over ``model``, edge and triplet arrays over
          ``(pod, data)``; params replicated.
  recsys: embedding-table rows over ``model``, batch over ``(pod,
          data)``; tower MLPs replicated.

Every rule is divisibility-checked against the mesh: axes that do not
divide the dim are dropped (always a coarser sharding, never an error).

Trees are the port's: an ``nn.Module`` reads as the nested dicts of its
parameter names split at the dots (``train.tree``), so a spec tree has
the reference's structure and ``norm_path`` gives the reference's slash
paths (``layers.attn.wq`` -> ``layers/attn/wq``).

Activations.  Model code annotates activations with LOGICAL axis names
via ``shard_act(x, ("batch", "sp", None))``; ``mesh_context`` activates
a ``DeviceMesh``, and ``LOGICAL_DEFAULT`` maps logical to mesh axes.
The port is one eager process over the mesh (``launch.mesh``): an
activation is computed whole on the step's device, so under a mesh
``shard_act`` checks the spec the reference would constrain to
(``_check_div`` of the mapped entries), records it in the active
context, and returns ``x`` unchanged, as the reference's
``with_sharding_constraint`` changes no value.
Pieces exist where the port's own code lays them out: params and inputs
through ``NamedSharding.shard``, and the MoE's expert exchange
(``models.moe.moe_forward_sharded``).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence, Tuple

from ..train.tree import leaves_with_paths, map_with_paths
from .mesh import (NamedSharding, PartitionSpec, axis_size, check_mesh,
                   filter_spec)

__all__ = ["LOGICAL_DEFAULT", "mesh_context",
           "current_mesh", "shard_act", "norm_path", "spec_by_rules",
           "lm_param_rules", "lm_param_specs", "opt_state_specs",
           "train_state_specs", "simple_spec"]

# --------------------------------------------------------------------- #
# logical activation-sharding context
# --------------------------------------------------------------------- #
_ACT_CTX: dict = {"mesh": None, "record": None}

LOGICAL_DEFAULT = {
    "batch": ("pod", "data"),    # data-parallel axes
    "tp": "model",               # tensor-parallel (heads / ffn / vocab)
    "sp": "model",               # sequence-parallel (Megatron-SP)
    "expert": "model",           # expert-parallel
    "graph": ("pod", "data", "model"),  # FD subset stacking
    # GNN: nodes and edges live on DIFFERENT axes (the reference's
    # layout: edge-endpoint gathers become an all-gather over `model`)
    "nodes": "model",
    "edges": ("pod", "data"),
}


class mesh_context:
    """``with mesh_context(mesh): ...`` scoped activation constraints.

    ``record`` maps each distinct ``(logical_entries, shape)`` that
    ``shard_act`` met inside the context to the spec it checked."""

    def __init__(self, mesh):
        self.mesh = check_mesh(mesh)
        self.record: Dict[Tuple, PartitionSpec] = {}

    def __enter__(self):
        self.prev = dict(_ACT_CTX)
        _ACT_CTX.update(mesh=self.mesh, record=self.record)
        return self.mesh

    def __exit__(self, *exc):
        _ACT_CTX.update(self.prev)
        return False


def current_mesh():
    return _ACT_CTX["mesh"]


def shard_act(x, logical_entries):
    """The identity.  Under an active mesh, the logical entries are
    mapped through ``LOGICAL_DEFAULT`` and divisibility-checked against
    ``x.shape``, as the reference's ``with_sharding_constraint``; the
    spec is recorded in the context (names that map to no mesh axis
    filtered, as there)."""
    mesh = _ACT_CTX["mesh"]
    if mesh is None:
        return x
    phys = tuple(None if e is None else LOGICAL_DEFAULT.get(e, e)
                 for e in logical_entries)
    shape = tuple(x.shape)
    _ACT_CTX["record"][(tuple(logical_entries), shape)] = _check_div(
        shape, phys, mesh)
    return x


def norm_path(path) -> str:
    """A leaf's slash path: a tree path tuple (``('layers', 'attn',
    'wq')``, list indices as ints), a parameter name (``layers.attn.wq``)
    or a ``keystr`` (``['layers']['attn']['wq']``) -> ``layers/attn/wq``."""
    if isinstance(path, str):
        if path.startswith("["):
            return re.sub(r"\[('?)([^'\]]*)\1\]", r"/\2", path).lstrip("/")
        return path.replace(".", "/")
    return "/".join(str(p) for p in path)


def _check_div(shape, entries, mesh) -> PartitionSpec:
    """Drop axes that don't evenly divide their dim; filter absent axes."""
    out = []
    for i, e in enumerate(entries):
        if e is None or i >= len(shape):
            out.append(None)
            continue
        names = e if isinstance(e, (tuple, list)) else (e,)
        names = tuple(n for n in names if n in mesh.axis_names)
        keep = []
        size = 1
        for n in names:
            s = axis_size(mesh, n)
            if shape[i] % (size * s) == 0:
                keep.append(n)
                size *= s
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return PartitionSpec(*out)


def spec_by_rules(tree: Any, rules: Sequence[Tuple[str, Sequence]], mesh,
                  default: Sequence = ()) -> Any:
    """Map each leaf to a NamedSharding via the first matching path rule.

    rules: (regex, entries) — entries is a PartitionSpec-like tuple that
    is divisibility-filtered per leaf shape.  Leaves with no matching rule
    get ``default`` (replicated if empty)."""
    def assign(path, leaf):
        pstr = norm_path(path)
        shape = tuple(getattr(leaf, "shape", ()))
        for pat, entries in rules:
            if re.search(pat, pstr):
                return NamedSharding(mesh, _check_div(shape, entries, mesh))
        return NamedSharding(mesh, _check_div(shape, default, mesh))

    return map_with_paths(assign, tree)


# --------------------------------------------------------------------- #
# LM rules
# --------------------------------------------------------------------- #
def lm_param_rules(scan_stacked: bool = True) -> List[Tuple[str, Sequence]]:
    """Rules for transformer params.  Stacked layer params have a leading
    L axis (never sharded).  FSDP axis = (pod, data); TP/EP axis = model."""
    L = None  # leading layer axis placeholder
    fsdp = ("pod", "data")
    return [
        # MoE shared experts (must precede the generic moe rules)
        (r"moe/shared/(gate|up)$", (L, fsdp, "model")),
        (r"moe/shared/down$", (L, "model", fsdp)),
        # MoE experts: (L, E, d, f) / (L, E, f, d) — EP on E, FSDP on last
        (r"moe/(gate|up)$", (L, "model", fsdp, None)),
        (r"moe/down$", (L, "model", None, fsdp)),
        (r"moe/router$", (L, None, None)),
        (r"moe/router_bias$", (L, None)),
        # MTP projection (2d, d)
        (r"mtp/proj$", (fsdp, "model")),
        # attention (GQA): wq/wk/wv (L, d, H*dh) TP on heads; wo transposed
        (r"attn/w[qkv]$", (L, fsdp, "model")),
        (r"attn/wo$", (L, "model", fsdp)),
        # MLA
        (r"attn/wq_a$", (L, fsdp, None)),
        (r"attn/wq_b$", (L, None, "model")),
        (r"attn/wkv_a$", (L, fsdp, None)),
        (r"attn/wkv_b$", (L, None, "model")),
        # dense mlp (L, d, f) / (L, f, d)
        (r"mlp/(gate|up)$", (L, fsdp, "model")),
        (r"mlp/down$", (L, "model", fsdp)),
        # embeddings: vocab over model, d over fsdp
        (r"(embed|lm_head)$", ("model", fsdp)),
        # norms / everything else: replicated
    ]


def _shift_for_rank(entries, rank):
    """Right-align entry tuple to leaf rank (handles stacked vs unstacked)."""
    entries = tuple(entries)
    if len(entries) > rank:
        return entries[len(entries) - rank:]
    if len(entries) < rank:
        return (None,) * (rank - len(entries)) + entries
    return entries


def lm_param_specs(abstract_params, mesh):
    rules = lm_param_rules()

    def assign(path, leaf):
        pstr = norm_path(path)
        shape = tuple(leaf.shape)
        for pat, entries in rules:
            if re.search(pat, pstr):
                ent = _shift_for_rank(entries, len(shape))
                return NamedSharding(mesh, _check_div(shape, ent, mesh))
        return NamedSharding(mesh, PartitionSpec())

    return map_with_paths(assign, abstract_params)


def opt_state_specs(param_specs):
    """m/v shadow the param shardings; step is replicated (the structure
    of ``optimizer.adamw_init``'s state)."""
    mesh = leaves_with_paths(param_specs)[0][1].mesh
    return {
        "m": map_with_paths(lambda _, s: s, param_specs),
        "v": map_with_paths(lambda _, s: s, param_specs),
        "step": NamedSharding(mesh, PartitionSpec()),
    }


def train_state_specs(param_specs):
    return {"params": param_specs, "opt": opt_state_specs(param_specs)}


# --------------------------------------------------------------------- #
# activation / input helpers
# --------------------------------------------------------------------- #
def simple_spec(mesh, entries, shape=None) -> NamedSharding:
    if shape is not None:
        return NamedSharding(mesh, _check_div(tuple(shape), entries, mesh))
    # no divisibility info: filter absent axes only
    return NamedSharding(mesh, filter_spec(mesh, *entries))
