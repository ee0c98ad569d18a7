"""Carry the reference package's inputs and results across to the port.

There are no weights in this system: what crosses over is a graph, a
config and run statistics.  The tests build each case once with numpy and
hand it to both packages through these functions.

* ``graph_from_arrays`` — a port graph from plain edge arrays;
* ``config_from_fields`` — the port's ``ReceiptConfig`` from
  ``dataclasses.asdict`` of a reference config (``dtype`` given as a numpy
  dtype name), mapping the reference's backend names;
* ``engine_config_from_fields`` — the port's ``api.EngineConfig`` from a
  reference ``EngineConfig.to_dict()``, backends mapped the same way;
* ``stats_fields`` — a port ``RunStats`` as a plain dict.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .core.engine.peel_loop import ReceiptConfig, RunStats
from .core.graph import BipartiteGraph

__all__ = ["graph_from_arrays", "config_from_fields",
           "engine_config_from_fields", "stats_fields"]

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


def stats_fields(stats: RunStats) -> Dict[str, Any]:
    return dataclasses.asdict(stats)
