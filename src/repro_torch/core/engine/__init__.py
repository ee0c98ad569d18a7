"""RECEIPT peel engine package (port of ``repro.core.engine``).

* `peel_loop.py` — the sweep core (vertex axis), ``ReceiptConfig``,
  ``RunStats``
* `cd.py`        — RECEIPT CD (Alg. 3), range-peel mode, subset and
  whole-graph dispatch
* `fd.py`        — RECEIPT FD (Alg. 4), batched level-peel mode, and the
  legacy sequential ``fd_mode="b2"`` / ``"matvec"`` engines
* `tiled.py`     — the whole-graph level peel over the nonzero-tile list
  (``representation="tiled"``)
* `baselines.py` — the ParButterfly min-peel baseline

``tip_decompose`` below is the top-level entry point (CD then FD, or the
tiled engine, with the degree-sort relabeling and the side="V"
transpose).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..graph import BipartiteGraph
from .baselines import parb_tip_decompose
from .cd import cd_checkpoint_state, find_hi_np, receipt_cd
from .fd import build_fd_tasks, build_level_stack, receipt_fd
from .peel_loop import (
    DeviceGraph,
    ReceiptConfig,
    RunStats,
    batched_level_loop,
    bucket,
    cd_graph_state0,
    device_cd_graph_loop,
    device_peel_loop,
    host_sweep,
    resolve_device,
)
from .tiled import build_tiled, receipt_tiled, tiled_blocks

__all__ = [
    "ReceiptConfig",
    "RunStats",
    "tip_decompose",
    "receipt_cd",
    "receipt_fd",
    "receipt_tiled",
    "tiled_blocks",
    "build_tiled",
    "parb_tip_decompose",
    "cd_checkpoint_state",
    "find_hi_np",
    "build_fd_tasks",
    "build_level_stack",
    "DeviceGraph",
    "device_peel_loop",
    "device_cd_graph_loop",
    "cd_graph_state0",
    "batched_level_loop",
    "host_sweep",
    "bucket",
]


def tip_decompose(
    g: BipartiteGraph, cfg: Optional[ReceiptConfig] = None,
    *, side: str = "U", device=None, plan=None,
) -> Tuple[np.ndarray, RunStats]:
    """Full RECEIPT tip decomposition of one side of ``g``.

    side="V" peels the other vertex set, by transposing the bipartite
    graph (exact by symmetry).  ``device=None`` runs on the card.
    ``plan``: a ``repro_torch.api.ExecutionPlan`` whose earlier
    same-signature runs set the FD gather widths, and which receives this
    run's measurements, padded shapes among them (recorded, never
    changed; the hooks are listed in `cd.py`, `fd.py` and `tiled.py`);
    ``None`` sizes everything from ``g``.  The representation is ``cfg.representation``: ``"tiled"``
    runs the tiled engine, anything else the dense pipeline (the Planner
    resolves ``"auto"`` before a run reaches here).

    Returns (theta int64[n_side], RunStats).
    """
    cfg = cfg or ReceiptConfig()
    dev = resolve_device(device)
    if side == "V":
        g = g.transposed()
    elif side != "U":
        raise ValueError(f"side must be 'U' or 'V', got {side!r}")
    stats = RunStats()
    if cfg.degree_sort:
        # relabel for tile density; map results back at the end
        du = g.degrees_u()
        perm_u = np.argsort(-du, kind="stable")
        dv = g.degrees_v()
        perm_v = np.argsort(-dv, kind="stable")
        inv_u = np.empty_like(perm_u)
        inv_u[perm_u] = np.arange(g.n_u)
        inv_v = np.empty_like(perm_v)
        inv_v[perm_v] = np.arange(g.n_v)
        g_work = BipartiteGraph.from_edges(
            g.n_u, g.n_v, inv_u[g.edges_u], inv_v[g.edges_v]
        )
    else:
        perm_u = np.arange(g.n_u)
        g_work = g

    if cfg.representation == "tiled":
        # blocked-sparse whole-graph level peel: the same theta (tip
        # numbers are canonical across exact schedules) without the dense
        # biadjacency
        theta_work = receipt_tiled(g_work, cfg, stats, device=dev, plan=plan)
    else:
        subset_id, init_support, bounds, _ = receipt_cd(g_work, cfg, stats,
                                                        device=dev, plan=plan)
        theta_work = receipt_fd(g_work, subset_id, init_support, bounds,
                                cfg, stats, device=dev, plan=plan)

    theta = np.zeros(g.n_u, np.int64)
    theta[perm_u] = np.round(theta_work).astype(np.int64)
    return theta, stats
