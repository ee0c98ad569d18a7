"""RECEIPT peel engine package (port of ``repro.core.engine``).

* `peel_loop.py` — the sweep core (vertex axis), ``ReceiptConfig``,
  ``RunStats``
* `cd.py`        — RECEIPT CD (Alg. 3), range-peel mode, subset and
  whole-graph dispatch
* `fd.py`        — RECEIPT FD (Alg. 4), batched level-peel mode, and the
  legacy sequential ``fd_mode="b2"`` / ``"matvec"`` engines
* `tiled.py`     — the whole-graph level peel over the nonzero-tile list
  (``representation="tiled"``)
* `wing.py`      — wing (bitruss) decomposition on the EDGE axis (the
  same loops with the edge delta rule, ``DELTA_RULES``)
* `refresh.py`   — the exact incremental re-peel after edge mutations
  (``repeel_tip_prefix`` / ``repeel_wing_prefix``)
* `baselines.py` — the ParButterfly min-peel baseline

``tip_decompose`` below is the top-level entry point (CD then FD, or the
tiled engine, with the degree-sort relabeling and the side="V"
transpose).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...launch.mesh import check_mesh
from ...utils.spans import span
from ..graph import BipartiteGraph
from .baselines import parb_tip_decompose
from .cd import cd_checkpoint_state, find_hi_np, receipt_cd
from .fd import build_fd_tasks, build_level_stack, receipt_fd
from .peel_loop import (
    DELTA_RULES,
    EXACT_LIMIT,
    F32_EXACT_LIMIT,
    DeviceGraph,
    ReceiptConfig,
    RunStats,
    batched_level_loop,
    bucket,
    cd_graph_state0,
    check_exact,
    device_cd_graph_loop,
    device_peel_loop,
    exact_limit,
    host_sweep,
    resolve_device,
)
from .refresh import (repeel_tip_prefix, repeel_wing_prefix,
                      synthesize_bounds)
from .tiled import build_tiled, receipt_tiled, tiled_blocks
from .wing import (
    build_edge_state,
    device_wing_graph_loop,
    receipt_wing_cd,
    receipt_wing_fd,
    wing_decompose_engine,
    wing_graph_state0,
)

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
    "wing_decompose_engine",
    "receipt_wing_cd",
    "receipt_wing_fd",
    "device_wing_graph_loop",
    "wing_graph_state0",
    "build_edge_state",
    "repeel_tip_prefix",
    "repeel_wing_prefix",
    "synthesize_bounds",
    "DELTA_RULES",
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
    "EXACT_LIMIT",
    "F32_EXACT_LIMIT",
    "exact_limit",
    "check_exact",
]


def tip_decompose(
    g: BipartiteGraph, cfg: Optional[ReceiptConfig] = None,
    *, side: str = "U", device=None, mesh=None, plan=None,
) -> Tuple[np.ndarray, RunStats]:
    """Full RECEIPT tip decomposition of one side of ``g``.

    side="V" peels the other vertex set, by transposing the bipartite
    graph (exact by symmetry).  ``device=None`` runs on the card.
    ``mesh``: a ``repro_torch.launch.mesh.DeviceMesh`` runs the FD phase
    sharded over it (``core/distributed.py``: subsets LPT-assigned to its
    shard devices, per-shard stats reconciled into the returned
    RunStats); CD stays on ``device`` (DESIGN.md section 4).  Tip numbers
    are identical with and without a mesh.  Any other mesh object raises
    ``TypeError``.
    ``plan``: a ``repro_torch.api.ExecutionPlan`` whose earlier
    same-signature runs set the FD gather widths, and which receives this
    run's measurements, padded shapes among them (recorded, never
    changed; the hooks are listed in `cd.py`, `fd.py` and `tiled.py`);
    ``None`` sizes everything from ``g``.  The representation is ``cfg.representation``: ``"tiled"``
    runs the tiled engine, anything else the dense pipeline (the Planner
    resolves ``"auto"`` before a run reaches here).

    The span ``engine.prepare`` (``utils.spans``) times the degree sort
    and relabel, on the returned stats' ``trace``.

    Every tip number is exact while every butterfly support stays below
    the route's limit (``peel_loop.exact_limit``, DESIGN.md section 8):
    2^53 on the dense pipeline on one device, 2^24 on the tiled
    representation and with a ``mesh``.  A counted support at or past it
    raises ``PlanInfeasibleError`` and returns no numbers.

    Returns (theta int64[n_side], RunStats).
    """
    cfg = cfg or ReceiptConfig()
    dev = resolve_device(device)
    if mesh is not None:
        check_mesh(mesh)
    if side == "V":
        g = g.transposed()
    elif side != "U":
        raise ValueError(f"side must be 'U' or 'V', got {side!r}")
    stats = RunStats()
    if cfg.degree_sort:
        # relabel for tile density; map results back at the end
        with span("engine.prepare", stats):
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
        subset_id, init_support, bounds, _ = receipt_cd(
            g_work, cfg, stats, device=dev, plan=plan,
            exact_limit=exact_limit(cfg.representation, mesh))
        theta_work = receipt_fd(g_work, subset_id, init_support, bounds,
                                cfg, stats, device=dev, mesh=mesh,
                                plan=plan)

    theta = np.zeros(g.n_u, np.int64)
    theta[perm_u] = np.round(theta_work).astype(np.int64)
    return theta, stats
