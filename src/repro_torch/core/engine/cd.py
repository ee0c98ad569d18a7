"""CD — coarse-grained decomposition (the paper's Alg. 3).

Port of ``repro.core.engine.cd``.  Partitions U into subsets with
non-overlapping tip-number ranges by running the peel core
(`engine/peel_loop.py`) in range-peel mode.  Two dispatches:

* ``cd_dispatch="subset"``: one device loop per subset; host-side
  adaptive range determination (findHi on the per-subset support
  snapshot), DGM re-induction at subset boundaries and checkpointing.
* ``cd_dispatch="graph"`` (``_receipt_cd_graph``): the whole CD phase in
  ``device_cd_graph_loop``, with findHi, the FD init snapshot, subset
  stamping and DGM (column compaction, staircase re-tightening, HUC bound
  re-estimate) on the device; the ``DeviceGraph`` is built and uploaded
  once.

The reference's peel-buffer overflow replay has no counterpart in either:
the port sizes each gather to its peel set.

With a ``plan`` (``repro_torch.api.ExecutionPlan``), every ``DeviceGraph``
records its padded shape through the plan (``dgm_rows`` / ``dgm_cols``:
the reference's shape hook, which changes no shape here), and the run
records its widest CD gather with ``plan.note_cd_peel_width``.  That width is a measurement only:
the reference pins its peel buffer to the measured width, while here every
gather is sized to its own peel set, so nothing reads it back.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from ...api.errors import KernelBackendError
from ...api.faults import fault_point
from ...kernels import ops as kops
from ..graph import BipartiteGraph
from .peel_loop import (
    _INF,
    DeviceGraph,
    ReceiptConfig,
    RunStats,
    cd_graph_state0,
    device_cd_graph_loop,
    device_peel_loop,
    fetch,
    host_sweep,
    support_all,
)

__all__ = ["receipt_cd", "cd_checkpoint_state", "find_hi_np"]

_GRAPH_CHECKPOINT_ERROR = (
    "CD checkpointing captures subset-boundary state on the host; use "
    "cd_dispatch='subset'")


def find_hi_np(support: np.ndarray, w: np.ndarray, alive: np.ndarray,
               tgt: float) -> float:
    """Adaptive range upper bound (Alg. 3 findHi) on the host snapshot.

    Sort alive supports ascending, prefix-sum their wedge counts, pick the
    smallest support whose cumulative wedge count reaches the target.
    Falls back to max support + 1 (catch-all) when the target exceeds the
    remaining wedge mass.
    """
    sup = np.where(alive, support, np.inf)
    order = np.argsort(sup, kind="stable")
    ws = np.where(alive, w, 0.0)[order]
    cum = np.cumsum(ws)
    hit = cum >= tgt
    if hit.size and hit[-1]:
        hi = sup[order][int(np.argmax(hit))]
    else:
        hi = float(np.max(np.where(alive, support, -np.inf)))
    return float(hi) + 1.0


def cd_checkpoint_state(subset_id, init_support, bounds, members, support_np,
                        rem_wedges, scale, lo, i):
    """CD loop state as a plain dict of numpy values (restart is exact
    because CD is deterministic given this state)."""
    return {
        "subset_id": np.asarray(subset_id),
        "init_support": np.asarray(init_support),
        "bounds": np.asarray(bounds, np.float64),
        "members": np.asarray(members),
        "support": np.asarray(support_np, np.float64),
        "rem_wedges": np.float64(rem_wedges),
        "scale": np.float64(scale),
        "lo": np.float64(lo),
        "i": np.int64(i),
    }


def _fresh_state(dg: DeviceGraph, sup_keep: np.ndarray, cfg: ReceiptConfig):
    """Device support/alive vectors of a (re-)induced graph whose first
    ``n_rows`` rows are alive with supports ``sup_keep``."""
    dev = dg.a.device
    alive = torch.zeros(dg.rows_pad, dtype=torch.bool, device=dev)
    alive[: dg.n_rows] = True
    support = torch.full((dg.rows_pad,), _INF, dtype=cfg.dtype, device=dev)
    support[: dg.n_rows] = torch.as_tensor(sup_keep, dtype=cfg.dtype,
                                           device=dev)
    return support, alive


def receipt_cd(
    g: BipartiteGraph, cfg: ReceiptConfig, stats: RunStats,
    *, device, checkpoint_cb=None, resume_state=None, plan=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, None]:
    """Partition U into subsets with non-overlapping tip-number ranges.

    Returns (subset_id[n_u], init_support[n_u], bounds[P+1], None) where
    subset_id[u] in [0, P), init_support is the FD support initialization
    vector (Alg. 3 line 7) and bounds[i] = theta(i+1) lower bounds,
    bounds[-1] > theta_max.

    With ``cfg.device_loop`` (default) each subset's sweeps run in
    ``device_peel_loop``; the host snapshots supports once per subset
    (needed for the FD init vector and findHi anyway).
    ``device_loop=False`` drives every sweep through ``host_sweep``.

    checkpoint_cb(state): called with a ``cd_checkpoint_state`` dict at
    every subset boundary.  resume_state: continue an interrupted run
    from such a state.  Both need ``cd_dispatch="subset"``.  ``plan``:
    see the module docstring (``None`` sizes everything from the graph).
    """
    if cfg.max_sweeps < 1:
        raise ValueError(
            f"max_sweeps must be >= 1 (got {cfg.max_sweeps}): the valve "
            "bounds one device-loop invocation; a sub-1 cap can make no "
            "progress and would break Theorem 1's range containment")
    if cfg.cd_dispatch not in ("subset", "graph"):
        raise ValueError(f"unknown cd_dispatch {cfg.cd_dispatch!r}")
    if cfg.cd_dispatch == "graph":
        if not cfg.device_loop:
            raise ValueError(
                "cd_dispatch='graph' runs the whole CD phase on device "
                "and requires device_loop=True")
        if checkpoint_cb is not None or resume_state is not None:
            raise ValueError(_GRAPH_CHECKPOINT_ERROR)
        return _receipt_cd_graph(g, cfg, stats, device=device, plan=plan)
    backend = kops.resolve_backend(cfg.backend, device)
    sparse = backend in kops.SPARSE_BACKENDS
    blocks = cfg.kernel_blocks
    n_u = g.n_u
    p_total = cfg.num_partitions

    t0 = time.perf_counter()
    if resume_state is not None:
        st = resume_state
        subset_id = np.asarray(st["subset_id"]).copy()
        init_support = np.asarray(st["init_support"]).copy()
        bounds = [float(b) for b in st["bounds"]]
        dg = DeviceGraph(g, np.asarray(st["members"]), cfg, device=device,
                         plan=plan)
        stats.wedges_pvbcnt = g.counting_wedge_bound()
        support, alive = _fresh_state(dg, st["support"][: dg.n_rows], cfg)
        dv = dg.dv0
        sup_np, alive_np = fetch(stats, support, alive)
        alive_np = alive_np.astype(bool)
        rem_wedges = float(st["rem_wedges"])
        scale = float(st["scale"])
        lo = float(st["lo"])
        i = int(st["i"])
    else:
        subset_id = np.full(n_u, -1, np.int64)
        init_support = np.zeros(n_u, np.float64)
        bounds = [0.0]

        dg = DeviceGraph(g, np.arange(n_u), cfg, device=device, plan=plan)
        stats.wedges_pvbcnt = g.counting_wedge_bound()

        # --- initial per-vertex counting (pvBcnt) ---------------------- #
        alive = torch.zeros(dg.rows_pad, dtype=torch.bool, device=device)
        alive[: dg.n_rows] = True
        fault_point("kernel_launch", KernelBackendError,
                    dispatch="subset", backend=backend, phase="count")
        support = support_all(dg.a, alive, dg.ids,
                              dg.kmax if sparse else None,
                              backend=backend, blocks=blocks)
        support = torch.where(alive, support, _INF)
        dv = dg.dv0
        sup_np, alive_np = fetch(stats, support, alive)   # the blocking sync
        alive_np = alive_np.astype(bool)
        stats.time_count = time.perf_counter() - t0

        t0 = time.perf_counter()
        rem_wedges = dg.total_wedges
        scale = 1.0
        lo = 0.0
        i = 0

    widths = []
    while alive_np.any():
        if checkpoint_cb is not None:
            live = np.where(alive_np)[0]
            checkpoint_cb(cd_checkpoint_state(
                subset_id, init_support, bounds, dg.members[live],
                sup_np[live], rem_wedges, scale, lo, i,
            ))
        # final catch-all subset (paper: "puts all of them in U_{P+1}")
        catch_all = i >= p_total - 1
        tgt = np.inf if catch_all else max(rem_wedges / (p_total - i) * scale, 1.0)

        # support snapshot -> FD init vector (Alg. 3 lines 6-7)
        live_rows = np.where(alive_np)[0]
        init_support[dg.members[live_rows]] = sup_np[live_rows]

        if catch_all:
            hi = float(np.max(np.where(alive_np, sup_np, -np.inf))) + 1.0
        else:
            hi = find_hi_np(sup_np, dg.w_np, alive_np, tgt)

        sweeps = 0
        covered_wedges = 0.0
        if cfg.device_loop:
            # degrade-style site of the reference (it undersizes the peel
            # buffer); the port sizes every gather to its peel set, so
            # there is no buffer to undersize
            fault_point("peel_buffer", dispatch="subset", subset=i,
                        backend=backend)
            while True:
                fault_point("kernel_launch", KernelBackendError,
                            dispatch="subset", subset=i, backend=backend)
                (support, alive, dv, _th, peeled, d_rho, d_wedges, d_hucs,
                 d_elided, d_covered, _d_sweeps, _ovf) = device_peel_loop(
                    dg.a, dg.ids, support, alive, dv,
                    torch.zeros(dg.rows_pad, dtype=torch.float32,
                                device=device),
                    hi, lo, dg.c_rcnt, 0,
                    backend=backend, blocks=blocks, use_huc=cfg.use_huc,
                    max_sweeps=cfg.max_sweeps, minmode=False,
                    row_ext=dg.row_ext, kmax=dg.kmax, stats=stats,
                    widths=widths,
                )
                stats.device_loop_calls += 1
                peeled_np, alive_np, sup_np, d_wedges, d_covered = fetch(
                    stats, peeled, alive, support, d_wedges, d_covered)
                peeled_np = peeled_np.astype(bool)
                alive_np = alive_np.astype(bool)
                stats.rho_cd += d_rho
                stats.wedges_cd += int(d_wedges)
                stats.huc_recounts += d_hucs
                stats.elided_sweeps += d_elided
                sweeps += d_rho
                covered_wedges += float(d_covered)
                subset_id[dg.members[np.where(peeled_np)[0]]] = i
                # max_sweeps valve: caps ONE invocation, never the subset
                # — a cap-exit with range left re-enters (Theorem 1 needs
                # [lo, hi) fully drained before the bound is recorded)
                if not (alive_np & (sup_np < hi)).any():
                    break
                if d_rho == 0:
                    raise RuntimeError(
                        "CD device loop made no progress on a non-empty "
                        "range (max_sweeps misconfigured?)")
        else:
            # blocking host-driven sweeps: the host regains control at
            # every sweep, and each sweep peels >= 1 row, so the loop
            # terminates in <= n_rows sweeps
            while True:
                support, alive, info = host_sweep(
                    dg, cfg, stats, support, alive, hi, lo, backend, blocks)
                if info is None:
                    break
                sweeps += 1
                covered_wedges += info["c_peel"]
                subset_id[dg.members[info["peel_np"].nonzero()[0]]] = i
            sup_np, alive_np = fetch(stats, support, alive)
            alive_np = alive_np.astype(bool)

        stats.sweeps_per_subset.append(sweeps)
        bounds.append(hi)
        rem_wedges = max(rem_wedges - covered_wedges, 0.0)
        if covered_wedges > 0 and not catch_all:
            scale = min(1.0, tgt / covered_wedges)
        lo = hi
        i += 1
        if catch_all:
            break

        # --- DGM: re-induce the residual graph into smaller buckets ---- #
        n_alive = int(alive_np.sum())
        if n_alive == 0:
            break
        if cfg.use_dgm and n_alive < cfg.dgm_row_threshold * dg.rows_pad:
            fault_point("dgm_boundary", KernelBackendError,
                        dispatch="subset", subset=i, backend=backend)
            live = np.where(alive_np)[0]
            new_members = dg.members[live]
            sup_keep = sup_np[live]
            dg = DeviceGraph(g, new_members, cfg, device=device, plan=plan)
            stats.dgm_compactions += 1
            support, alive = _fresh_state(dg, sup_keep, cfg)
            dv = dg.dv0
            alive_np = np.zeros(dg.rows_pad, bool)
            alive_np[: dg.n_rows] = True
            sup_np = np.full(dg.rows_pad, np.inf)
            sup_np[: dg.n_rows] = sup_keep
            rem_wedges = dg.total_wedges

    stats.num_subsets = i
    stats.bounds = [float(b) for b in bounds]
    stats.time_cd = time.perf_counter() - t0
    if plan is not None and widths:
        plan.note_cd_peel_width(max(widths))
    # every vertex must be assigned
    if not (subset_id >= 0).all():
        raise RuntimeError("CD left unassigned vertices")
    return subset_id, init_support, np.asarray(bounds), None


def _receipt_cd_graph(g: BipartiteGraph, cfg: ReceiptConfig,
                      stats: RunStats, *, device, plan=None):
    """Whole-graph CD (reference ``_receipt_cd_graph``): count, then every
    subset in ``device_cd_graph_loop``, re-entered only on a
    ``max_sweeps`` cap-exit, then one fetch of the subset ids, the FD init
    vector and the bounds.

    ``dgm_compactions`` stays 0 (the residual graph is compacted on the
    card, counted in ``dgm_device_compactions``); ``host_round_trips``
    counts the port's reads: one per sweep, one per HUC choice, and the
    final fetch.
    """
    backend = kops.resolve_backend(cfg.backend, device)
    blocks = cfg.kernel_blocks
    n_u = g.n_u
    p_total = cfg.num_partitions

    t0 = time.perf_counter()
    subset_id = np.full(n_u, -1, np.int64)
    init_support = np.zeros(n_u, np.float64)
    dg = DeviceGraph(g, np.arange(n_u), cfg, device=device, plan=plan)
    stats.wedges_pvbcnt = g.counting_wedge_bound()

    alive = torch.zeros(dg.rows_pad, dtype=torch.bool, device=device)
    alive[: dg.n_rows] = True
    fault_point("kernel_launch", KernelBackendError,
                dispatch="graph", backend=backend, phase="count")
    support = support_all(dg.a, alive, dg.ids, dg.kmax, backend=backend,
                          blocks=blocks)
    support = torch.where(alive, support, _INF)
    # asynchronous: no blocking read between counting and the CD loop
    stats.time_count = time.perf_counter() - t0

    t0 = time.perf_counter()
    # degrade-style site of the reference (it undersizes the peel
    # buffer); every gather here is sized to its peel set
    fault_point("peel_buffer", dispatch="graph", backend=backend)
    state = cd_graph_state0(dg, support, alive, p_total)
    widths = []
    while True:
        fault_point("kernel_launch", KernelBackendError,
                    dispatch="graph", backend=backend)
        state = device_cd_graph_loop(
            dg.ids, state, backend=backend, blocks=blocks,
            use_huc=cfg.use_huc, use_dgm=cfg.use_dgm,
            max_iters=cfg.max_sweeps, p_total=p_total, stats=stats,
            widths=widths)
        stats.device_loop_calls += 1
        if state["done"]:
            break
        state["iters"] = 0                    # fresh invocation budget
        if state["dgm"]:
            fault_point("dgm_boundary", KernelBackendError,
                        dispatch="graph", backend=backend,
                        compactions=state["dgm"])

    num_subsets = state["i"] + 1
    subset_of, init_sup, bounds_dev, wedges = fetch(
        stats, state["subset_of"][: dg.n_rows], state["init_sup"][: dg.n_rows],
        state["bounds"], state["wedges"])
    subset_id[dg.members] = subset_of.astype(np.int64)
    init_support[dg.members] = init_sup
    bounds = [0.0] + [float(b) for b in bounds_dev[1: num_subsets + 1]]
    stats.rho_cd += state["rho"]
    stats.wedges_cd += int(wedges)
    stats.huc_recounts += state["hucs"]
    stats.elided_sweeps += state["elided"]
    stats.dgm_device_compactions += state["dgm"]
    stats.sweeps_per_subset.extend(state["rho_sub"][:num_subsets])
    stats.num_subsets = num_subsets
    stats.bounds = bounds
    stats.time_cd = time.perf_counter() - t0
    if plan is not None and widths:
        plan.note_cd_peel_width(max(widths))
    if not (subset_id >= 0).all():
        raise RuntimeError("CD left unassigned vertices")
    return subset_id, init_support, np.asarray(bounds), None
