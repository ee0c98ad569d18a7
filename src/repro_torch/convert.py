"""Carry the reference package's inputs and results across to the port.

What crosses over is a graph, a config and run statistics for the
engine, and a parameter tree and an optimizer config for the models
(whose inputs are seeded numpy draws, so only the weights, drawn by
JAX's random stream in the reference, need carrying).  The tests build
each case once with numpy and hand it to both packages through these
functions.

* ``graph_from_arrays`` — a port graph from plain edge arrays;
* ``config_from_fields`` — the port's ``ReceiptConfig`` from
  ``dataclasses.asdict`` of a reference config (``dtype`` given as a numpy
  dtype name), mapping the reference's backend names;
* ``engine_config_from_fields`` — the port's ``api.EngineConfig`` from a
  reference ``EngineConfig.to_dict()``, backends mapped the same way;
* ``service_config_from_fields`` — the port's ``service.ServiceConfig``
  from ``dataclasses.asdict`` of a reference ``ServiceConfig``;
* ``stats_fields`` — a port ``RunStats`` as a plain dict;
* ``load_params`` — the reference's parameter tree (numpy arrays) into a
  port model: ``['user_tables'][0]`` is ``user_tables.0``,
  ``['user_mlp']['layers'][0]['w']`` is ``user_mlp.layers.0.w``, and the
  GNNs' lists of dicts alike (``['processor'][15]['node_mlp']...`` is
  ``processor.15.node_mlp...``); ``params_tree`` is the way back;
* ``adamw_config_from_fields`` — the port's ``AdamWConfig`` from
  ``dataclasses.asdict`` of a reference one (``state_dtype`` anything
  ``numpy.dtype`` reads, a name among them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .core.engine.peel_loop import ReceiptConfig, RunStats
from .core.graph import BipartiteGraph

__all__ = ["graph_from_arrays", "config_from_fields",
           "engine_config_from_fields", "service_config_from_fields",
           "stats_fields", "load_params", "params_tree",
           "adamw_config_from_fields"]

# the reference's backends and their counterparts here: the interpreter
# and the jnp oracle run the kernels' plain versions; the compiled
# Pallas kernels become the hand-written CUDA kernels, the staircase ones
# their stripe-skipping twins
BACKEND_MAP = {None: None, "xla": "torch", "interpret": "torch",
               "pallas": "cuda", "pallas_sparse": "cuda_sparse",
               "interpret_sparse": "torch_sparse"}


def graph_from_arrays(n_u: int, n_v: int, edges_u, edges_v) -> BipartiteGraph:
    return BipartiteGraph.from_edges(int(n_u), int(n_v),
                                     np.asarray(edges_u), np.asarray(edges_v))


def config_from_fields(d: Dict[str, Any]) -> ReceiptConfig:
    """The port's config from a reference config's fields.

    ``d["dtype"]`` is a numpy dtype name (``"float32"``).  Backends map
    through ``BACKEND_MAP``: ``xla``/``interpret`` -> ``torch``,
    ``pallas`` -> ``cuda``, ``pallas_sparse`` -> ``cuda_sparse`` and
    ``interpret_sparse`` -> ``torch_sparse``.
    """
    d = dict(d)
    backend = d.get("backend")
    if backend not in BACKEND_MAP:
        raise ValueError(f"unknown reference backend {backend!r}")
    d["backend"] = BACKEND_MAP[backend]
    d["dtype"] = getattr(torch, np.dtype(d.get("dtype", "float32")).name)
    d["kernel_blocks"] = tuple(d.get("kernel_blocks", (128, 128, 512)))
    return ReceiptConfig(**d)


def engine_config_from_fields(d: Dict[str, Any]):
    """The port's ``EngineConfig`` from a reference ``EngineConfig``'s
    ``to_dict()`` (a config and a graph are all that cross between the
    packages).  The backend maps through ``BACKEND_MAP``; every other key
    goes through ``EngineConfig.from_dict``, which rejects unknown ones."""
    from .api.config import EngineConfig

    d = dict(d)
    backend = d.get("backend")
    if backend not in BACKEND_MAP:
        raise ValueError(f"unknown reference backend {backend!r}")
    d["backend"] = BACKEND_MAP[backend]
    return EngineConfig.from_dict(d)


def service_config_from_fields(d: Dict[str, Any]):
    """The port's ``ServiceConfig`` from a reference ``ServiceConfig``'s
    fields (``dataclasses.asdict``), the service's counterpart of
    ``engine_config_from_fields``: the fields are the same, and an
    unknown one raises ``TypeError``."""
    from .service.state import ServiceConfig

    return ServiceConfig(**d)


def stats_fields(stats: RunStats) -> Dict[str, Any]:
    return dataclasses.asdict(stats)


def load_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy the reference's parameter tree (nested dicts and lists of
    numpy arrays) into ``module``'s parameters of the same paths, in
    place, each in the parameter's dtype on its device.  Every path must
    match, both ways, and every shape."""
    from .train.tree import keystr, leaves_with_paths

    src = {keystr(p): v for p, v in leaves_with_paths(tree)}
    dst = {keystr(p): t for p, t in leaves_with_paths(module)}
    if set(src) != set(dst):
        raise KeyError(f"parameter paths differ: only in the tree "
                       f"{sorted(set(src) - set(dst))}, only in the module "
                       f"{sorted(set(dst) - set(src))}")
    with torch.no_grad():
        for key, t in dst.items():
            arr = np.array(src[key], dtype=np.float32)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {arr.shape} against "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr).to(dtype=t.dtype))
    return module


def params_tree(module) -> Any:
    """The reference's nested param tree of ``module`` (or any tree of
    tensors), as float32 numpy arrays."""
    from .train.tree import map_leaves

    return map_leaves(
        lambda t: t.detach().to("cpu", torch.float32).numpy().copy(), module)


def adamw_config_from_fields(d: Dict[str, Any]):
    """The port's ``AdamWConfig`` from a reference config's fields; the
    state dtype maps by its numpy name (``float32`` -> ``torch.float32``,
    ``bfloat16`` -> ``torch.bfloat16``)."""
    from .train.optimizer import AdamWConfig

    d = dict(d)
    if "state_dtype" in d:
        d["state_dtype"] = getattr(torch, np.dtype(d["state_dtype"]).name)
    return AdamWConfig(**d)
