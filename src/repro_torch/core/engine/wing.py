"""Wing (bitruss) decomposition on the shared peel engine (port of
``repro.core.engine.wing``, DESIGN.md section 10).

Edge peeling rides the tip path's machinery: the support vector is per
EDGE SLOT, the geometry dict ``{"a", "eu", "ev"}`` (the residual
biadjacency plus the static edge endpoints) replaces the loop-invariant
matrix, and the CD range peel (``device_peel_loop(axis="edge")`` per
subset, or ``device_wing_graph_loop`` over every subset) and the batched
level FD (``batched_level_loop(axis="edge")``) are the peel core's loops
with the edge rule plugged in.

* **CD** partitions the edge set into subsets with non-overlapping
  wing-number ranges at equal-edge-count bounds (unit mass per edge):
  on the host support snapshot (``cd_dispatch="subset"``), or with
  ``kernels.ops.find_hi_device`` at ``w = 1`` (``cd_dispatch="graph"``).
* **FD** peels every subset at once in one (S, R, C) stack: subset s's
  member holds every edge of subsets >= s, only subset s's slots alive,
  supports recounted in the stack and floored at ``bounds[s]``; every
  sweep recounts in closed form, so simultaneous deletes never race.

Wing numbers are canonical (any exact peel schedule gives THE psi), so
every dispatch, backend and side equals ``core.wing.wing_bup_oracle``.
Degree-sort relabeling is skipped on this axis (edge slots stay in the
graph's canonical order); ``side="V"`` transposes and maps psi back
through the edge-order permutation.

The port's loops are Python loops over device tensors that read once per
sweep (the peel-set and alive sizes), so ``host_round_trips`` grows with
the sweeps on both dispatches, where the reference's graph dispatch
blocks O(1) times per graph.  With a ``plan``, the padded sizes are
recorded through ``plan.quantize_dim`` (``wing_rows``, ``wing_cols``,
``wing_edges``, ``wing_fd_groups``) and left as built.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ...api.errors import KernelBackendError
from ...api.faults import fault_point
from ...kernels import ops as kops
from ..graph import BipartiteGraph
from .peel_loop import (
    _INF,
    ReceiptConfig,
    RunStats,
    _peel_sizes,
    _sweep_once_edge,
    batched_level_loop,
    bucket,
    device_peel_loop,
    fetch,
    resolve_device,
)

__all__ = [
    "wing_decompose_engine",
    "receipt_wing_cd",
    "receipt_wing_fd",
    "device_wing_graph_loop",
    "wing_graph_state0",
    "build_edge_state",
]

_F32 = torch.float32


def build_edge_state(g: BipartiteGraph, cfg: ReceiptConfig, *, device,
                     plan=None) -> dict:
    """Bucket-padded edge-axis geometry + initial peel state (reference
    ``build_edge_state``).

    Edge slot j < m is ``(g.edges_u[j], g.edges_v[j])``, canonical order.
    Padding slots alias cell (0, 0) with ``alive=False``: every scatter
    they touch adds zero and every gather they make is masked by
    ``a[eu, ev]``.  ``c_rcnt`` is the reference's HUC break-even in
    peeled-edge units (``cols_pad / 3``) and ``peel_width`` its gather
    width, which its HUC rule reads; both only pick between exact
    branches.  ``eu``/``ev`` are int64 on ``device``.
    """
    bi, bj, bk = cfg.kernel_blocks
    rows_pad = bucket(max(g.n_u, 1), max(bi, bj))
    cols_pad = bucket(max(g.n_v, 1), bk)
    m_pad = bucket(max(g.m, 1), bj)
    if plan is not None:
        rows_pad = plan.quantize_dim("wing_rows", rows_pad)
        cols_pad = plan.quantize_dim("wing_cols", cols_pad)
        m_pad = plan.quantize_dim("wing_edges", m_pad)

    a = np.zeros((rows_pad, cols_pad), np.float32)
    a[g.edges_u, g.edges_v] = 1.0
    eu = np.zeros(m_pad, np.int64)
    ev = np.zeros(m_pad, np.int64)
    eu[: g.m] = g.edges_u
    ev[: g.m] = g.edges_v
    alive = np.zeros(m_pad, bool)
    alive[: g.m] = True

    if cfg.peel_width is not None:
        peel_width = min(bucket(cfg.peel_width, bj), m_pad)
    else:
        peel_width = min(bucket(max(bj, m_pad // 8), bj), m_pad)

    a_dev = torch.from_numpy(a).to(device=device, dtype=cfg.dtype)
    return dict(
        m=g.m, m_pad=m_pad, rows_pad=rows_pad, cols_pad=cols_pad,
        a=a_dev,
        eu=torch.from_numpy(eu).to(device), ev=torch.from_numpy(ev).to(device),
        eu_np=np.asarray(g.edges_u), ev_np=np.asarray(g.edges_v),
        alive0=alive,
        dv0=torch.from_numpy(a.sum(axis=0)).to(device),
        c_rcnt=max(float(cols_pad) / 3.0, 1.0),
        peel_width=peel_width,
    )


def _initial_supports(es: dict, cfg: ReceiptConfig, backend, dispatch):
    """Closed-form supports of every slot (+inf on padding) and the
    alive mask, on the device."""
    fault_point("kernel_launch", KernelBackendError,
                dispatch=dispatch, backend=backend, phase="count")
    support = kops.edge_support_all(es["a"], es["eu"], es["ev"],
                                    backend=backend,
                                    blocks=cfg.kernel_blocks)
    alive = torch.from_numpy(es["alive0"]).to(support.device)
    return torch.where(alive, support, _INF), alive


# ---------------------------------------------------------------------- #
# wing CD, subset dispatch (one peel loop per subset, host findHi)
# ---------------------------------------------------------------------- #
def receipt_wing_cd(
    g: BipartiteGraph, cfg: ReceiptConfig, stats: RunStats, *, device,
    plan=None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Partition the edge set into subsets with non-overlapping
    wing-number ranges (reference ``receipt_wing_cd``): the next bound is
    the support at the ``remaining / (P - i)``-th smallest alive support,
    and each range is drained by ``device_peel_loop(axis="edge")``
    (re-entered only on the ``max_sweeps`` cap).

    Returns (subset_id[m], bounds[S+1], edge_state).
    """
    backend = kops.resolve_backend(cfg.backend, device)
    blocks = cfg.kernel_blocks
    p_total = cfg.num_partitions

    t0 = time.perf_counter()
    es = build_edge_state(g, cfg, device=device, plan=plan)
    m = es["m"]
    subset_id = np.full(m, -1, np.int64)
    bounds = [0.0]
    support, alive = _initial_supports(es, cfg, backend, "wing_subset")
    geom = {"a": es["a"], "eu": es["eu"], "ev": es["ev"]}
    dv = es["dv0"]
    theta0 = torch.zeros(es["m_pad"], dtype=_F32, device=device)
    sup_np = fetch(stats, support)[0]
    alive_np = es["alive0"]
    stats.time_count = time.perf_counter() - t0

    t0 = time.perf_counter()
    peel_width = es["peel_width"]
    lo = 0.0
    i = 0
    while alive_np.any():
        catch = i >= p_total - 1
        if catch:
            hi = float(np.max(np.where(alive_np, sup_np, -np.inf))) + 1.0
        else:
            vals = np.sort(sup_np[alive_np])
            tgt = max(len(vals) // (p_total - i), 1)
            hi = float(vals[min(tgt - 1, len(vals) - 1)]) + 1.0
        sweeps = 0
        while True:
            fault_point("kernel_launch", KernelBackendError,
                        dispatch="wing_subset", subset=i, backend=backend)
            (geom, support, alive, dv, _th, peeled, d_rho, d_wedges,
             d_hucs, d_elided, _cov, _sw, _ovf) = device_peel_loop(
                geom, None, support, alive, dv, theta0, hi, lo,
                es["c_rcnt"], 0, backend=backend, blocks=blocks,
                use_huc=cfg.use_huc, max_sweeps=cfg.max_sweeps,
                minmode=False, stats=stats, axis="edge",
                peel_width=peel_width)
            stats.device_loop_calls += 1
            peeled_np, alive_np, sup_np, d_wedges = fetch(
                stats, peeled, alive, support, d_wedges)
            peeled_np = peeled_np.astype(bool)
            alive_np = alive_np.astype(bool)
            stats.rho_cd += d_rho
            stats.wedges_cd += int(d_wedges)
            stats.huc_recounts += d_hucs
            stats.elided_sweeps += d_elided
            sweeps += d_rho
            subset_id[np.where(peeled_np[:m])[0]] = i
            if not (alive_np & (sup_np < hi)).any():
                break
            if d_rho == 0:
                raise RuntimeError(
                    "wing CD peel loop made no progress on a non-empty "
                    "range (max_sweeps misconfigured?)")
        stats.sweeps_per_subset.append(sweeps)
        bounds.append(hi)
        lo = hi
        i += 1
        if catch:
            break

    stats.num_subsets = i
    stats.bounds = [float(b) for b in bounds]
    stats.time_cd = time.perf_counter() - t0
    if plan is not None:
        plan.note_cd_peel_width(peel_width)
    if not (subset_id >= 0).all():
        raise RuntimeError("wing CD left unassigned edges")
    es["a"] = None                      # FD builds its own stack
    return subset_id, np.asarray(bounds), es


# ---------------------------------------------------------------------- #
# wing CD, graph dispatch (every subset, boundaries on the device)
# ---------------------------------------------------------------------- #
def wing_graph_state0(es: dict, support, alive, p_total: int) -> dict:
    """Initial state of ``device_wing_graph_loop`` (reference
    ``wing_graph_state0``).  Tensors stay on the device; the counters and
    control fields are host values.  ``hi = -inf`` makes the first
    iteration a boundary, which opens subset 0 on the device;
    ``_receipt_wing_cd_graph`` re-enters a cap-exit with the returned
    state and a fresh ``iters``."""
    dev = support.device
    m_pad = es["m_pad"]

    def f32(x):
        return torch.full((), x, dtype=_F32, device=dev)

    return dict(
        a=es["a"], eu=es["eu"], ev=es["ev"], dv=es["dv0"],
        c_rcnt=es["c_rcnt"], support=support, alive=alive,
        subset_of=torch.full((m_pad,), -1, dtype=torch.int32, device=dev),
        bounds=torch.zeros(p_total + 1, dtype=_F32, device=dev),
        rho_sub=[], i=-1, hi=f32(-_INF), lo=f32(0.0),
        rho=0, wedges=f32(0.0), hucs=0, elided=0, covered=f32(0.0),
        rho_start=0, iters=0, done=False,
    )


def _wing_boundary(st: dict, n_alive: int, p_total: int) -> dict:
    """Close subset ``i`` (none on the first entry) and, unless no slot
    is alive, open ``i + 1`` with ``find_hi_device`` at unit mass per
    edge and the target ``n_alive / (P - i)`` computed in f32, as the
    reference's boundary branch.  No host read: ``n_alive`` is the
    sweep's size read."""
    i = st["i"]
    st = dict(st, iters=st["iters"] + 1)
    if i >= 0:
        st["bounds"][i + 1] = st["hi"]
        st["rho_sub"] = st["rho_sub"] + [st["rho"] - st["rho_start"]]
        st["lo"] = st["hi"]
    if n_alive == 0:
        return dict(st, done=True)
    i2 = i + 1
    if i2 >= p_total - 1:
        tgt = _INF
    else:
        tgt = max(np.float32(n_alive) / np.float32(max(p_total - i2, 1)),
                  np.float32(1.0))
    ones = torch.ones_like(st["support"])
    hi = kops.find_hi_device(st["support"], st["alive"], ones, float(tgt))
    return dict(st, i=i2, hi=hi, rho_start=st["rho"])


def device_wing_graph_loop(state: dict, *, backend, blocks, use_huc,
                           peel_width, max_iters, p_total,
                           stats=None) -> dict:
    """Every wing-CD subset over device-resident state (reference
    ``device_wing_graph_loop``).  Each iteration reads the sweep's peel
    and alive sizes; an empty peel set is a subset boundary
    (``_wing_boundary``), anything else one ``_sweep_once_edge`` whose
    peeled slots are stamped with the open subset.  No DGM step: edge
    peeling rewrites the carried biadjacency every sweep.  ``max_iters``
    bounds one invocation; the caller re-enters with the returned
    state."""
    st = dict(state)
    while not st["done"] and st["iters"] < max_iters:
        peel, n_peel, n_alive = _peel_sizes(st["support"], st["alive"],
                                            st["hi"], stats)
        if n_peel == 0:
            st = _wing_boundary(st, n_alive, p_total)
            continue
        geom = {"a": st["a"], "eu": st["eu"], "ev": st["ev"]}
        geom, support, alive, dv, wedges, covered, rec, eli = \
            _sweep_once_edge(
                geom, st["c_rcnt"], st["lo"], st["support"], st["alive"],
                st["dv"], st["wedges"], st["covered"], peel, n_peel,
                n_alive, backend=backend, blocks=blocks, use_huc=use_huc,
                peel_width=peel_width)
        st = dict(
            st, a=geom["a"], support=support, alive=alive, dv=dv,
            wedges=wedges, covered=covered, rho=st["rho"] + 1,
            hucs=st["hucs"] + int(rec), elided=st["elided"] + int(eli),
            subset_of=torch.where(peel, st["i"], st["subset_of"]),
            iters=st["iters"] + 1)
    return st


def _receipt_wing_cd_graph(
    g: BipartiteGraph, cfg: ReceiptConfig, stats: RunStats, *, device,
    plan=None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Whole-graph wing CD (reference ``_receipt_wing_cd_graph``): count,
    then every subset in ``device_wing_graph_loop``, re-entered only on a
    ``max_sweeps`` cap-exit, then one fetch of the subset ids, bounds and
    the wedge counter."""
    backend = kops.resolve_backend(cfg.backend, device)
    blocks = cfg.kernel_blocks
    p_total = cfg.num_partitions

    t0 = time.perf_counter()
    es = build_edge_state(g, cfg, device=device, plan=plan)
    m = es["m"]
    support, alive = _initial_supports(es, cfg, backend, "wing_graph")
    # asynchronous: no read between counting and the CD loop
    stats.time_count = time.perf_counter() - t0

    t0 = time.perf_counter()
    peel_width = es["peel_width"]
    state = wing_graph_state0(es, support, alive, p_total)
    es["a"] = None                      # the state owns the matrix now
    while True:
        fault_point("kernel_launch", KernelBackendError,
                    dispatch="wing_graph", backend=backend)
        state = device_wing_graph_loop(
            state, backend=backend, blocks=blocks, use_huc=cfg.use_huc,
            peel_width=peel_width, max_iters=cfg.max_sweeps,
            p_total=p_total, stats=stats)
        stats.device_loop_calls += 1
        if state["done"]:
            break
        state["iters"] = 0                    # max_sweeps cap-exit

    num_subsets = state["i"] + 1
    subset_of, bounds_dev, wedges = fetch(
        stats, state["subset_of"][:m], state["bounds"], state["wedges"])
    subset_id = subset_of.astype(np.int64)
    bounds = [0.0] + [float(b) for b in bounds_dev[1: num_subsets + 1]]
    stats.rho_cd += state["rho"]
    stats.wedges_cd += int(wedges)
    stats.huc_recounts += state["hucs"]
    stats.elided_sweeps += state["elided"]
    stats.sweeps_per_subset.extend(state["rho_sub"][:num_subsets])
    stats.num_subsets = num_subsets
    stats.bounds = [float(b) for b in bounds]
    del state
    stats.time_cd = time.perf_counter() - t0
    if plan is not None:
        plan.note_cd_peel_width(peel_width)
    if not (subset_id >= 0).all():
        raise RuntimeError("wing CD left unassigned edges")
    return subset_id, np.asarray(bounds), es


# ---------------------------------------------------------------------- #
# wing FD (one batched level peel over the subset stack)
# ---------------------------------------------------------------------- #
def receipt_wing_fd(
    g: BipartiteGraph, subset_id: np.ndarray, bounds: np.ndarray,
    cfg: ReceiptConfig, stats: RunStats, es: dict, *, device, plan=None,
) -> np.ndarray:
    """Exact wing numbers by a batched peel of the subset residual stack
    (reference ``receipt_wing_fd``): subset s's member holds every edge
    of subsets >= s, only subset s's slots alive, supports recounted in
    the stack and floored at ``bounds[s]``; one
    ``batched_level_loop(axis="edge")``, re-entered only on a
    ``max_sweeps`` cap-exit."""
    backend = kops.resolve_backend(cfg.backend, device)
    blocks = cfg.kernel_blocks
    t0 = time.perf_counter()
    m = es["m"]
    m_pad = es["m_pad"]
    psi = np.zeros(m, np.float64)
    sids = [s for s in range(int(subset_id.max()) + 1 if m else 0)
            if (subset_id == s).any()]
    for s in sids:
        stats.subset_sizes.append(int((subset_id == s).sum()))
    n_g = len(sids)
    if n_g == 0:
        stats.time_fd = time.perf_counter() - t0
        return psi
    n_gp = (plan.quantize_dim("wing_fd_groups", n_g) if plan is not None
            else n_g)

    slot_of = np.full(int(subset_id.max()) + 1, -1, np.int64)
    a = np.zeros((n_gp, es["rows_pad"], es["cols_pad"]), np.float32)
    alive = np.zeros((n_gp, m_pad), bool)
    los = np.zeros(n_gp, np.float32)
    eu_np, ev_np = es["eu_np"], es["ev_np"]
    for k, s in enumerate(sids):
        slot_of[s] = k
        resid = subset_id >= s
        a[k, eu_np[resid], ev_np[resid]] = 1.0
        alive[k, np.where(subset_id == s)[0]] = True
        los[k] = bounds[s]

    fault_point("kernel_launch", KernelBackendError,
                dispatch="wing_fd", backend=backend,
                group_shape=(n_gp, m_pad))
    dv_dev = torch.from_numpy(a.sum(axis=1)).to(device)
    a_dev = torch.from_numpy(a).to(device=device, dtype=cfg.dtype)
    del a
    alive_dev = torch.from_numpy(alive).to(device)
    lo_dev = torch.from_numpy(los).to(device)
    sup0 = kops.edge_support_all(a_dev, es["eu"], es["ev"],
                                 backend=backend, blocks=blocks)
    sup0 = torch.where(alive_dev, torch.maximum(sup0, lo_dev[:, None]),
                       _INF)

    def level_loop(a_c, sup, alv, dv_c):
        stats.device_loop_calls += 1
        return batched_level_loop(
            a_c, sup, alv, dv_c, lo_dev, backend=backend, blocks=blocks,
            peel_width=1, max_sweeps=cfg.max_sweeps, stats=stats,
            eu=es["eu"], ev=es["ev"], axis="edge")

    out = level_loop(a_dev, sup0, alive_dev, dv_dev)
    del a_dev, sup0
    stats.fd_groups = 1
    th_acc = np.zeros((n_gp, m_pad), np.float64)
    prev_alive = alive
    max_level_seen = 0
    while True:
        a_c, sup, alv, dv_c, th, rho, wedges, max_lev, _sw = out
        th_h, alive_h, rho_h, wedges_h, max_lev_h = fetch(
            stats, th, alv, rho, wedges, max_lev)
        alive_h = alive_h.astype(bool)
        d_rho = int(rho_h.sum())
        stats.rho_fd += d_rho
        stats.wedges_fd += int(wedges_h.sum())
        max_level_seen = max(max_level_seen, int(max_lev_h.max()))
        newly_dead = prev_alive & ~alive_h
        th_acc = np.where(newly_dead, th_h, th_acc)
        if not alive_h.any() or d_rho == 0:
            break
        prev_alive = alive_h
        out = level_loop(a_c, sup, alv, dv_c)     # cap-exit re-entry
    stats.fd_max_levels.append(max_level_seen)
    stats.fd_peel_widths.append(m_pad)

    psi = th_acc[slot_of[subset_id], np.arange(m)]
    stats.time_fd = time.perf_counter() - t0
    return psi


# ---------------------------------------------------------------------- #
# top-level driver (the wing twin of engine.tip_decompose)
# ---------------------------------------------------------------------- #
def wing_decompose_engine(
    g: BipartiteGraph, cfg: Optional[ReceiptConfig] = None,
    *, side: str = "U", device=None, plan=None,
) -> Tuple[np.ndarray, RunStats]:
    """Full wing decomposition of ``g`` (reference
    ``wing_decompose_engine``).

    Returns (psi int64[m], RunStats) with ``psi[j]`` the wing number of
    edge ``(g.edges_u[j], g.edges_v[j])``.  ``side="V"`` peels the
    transposed graph (psi is transpose-invariant) and maps back: the
    transpose sorts edges by (v, u), so
    ``psi[lexsort((edges_u, edges_v))] = psi_transposed``.
    ``device=None`` runs on the card.
    """
    cfg = cfg or ReceiptConfig()
    dev = resolve_device(device)
    if side == "V":
        psi_t, stats = wing_decompose_engine(
            g.transposed(), cfg, side="U", device=dev, plan=plan)
        psi = np.zeros(g.m, np.int64)
        psi[np.lexsort((g.edges_u, g.edges_v))] = psi_t
        return psi, stats
    if side != "U":
        raise ValueError(f"side must be 'U' or 'V', got {side!r}")
    stats = RunStats()
    if g.m == 0:
        return np.zeros(0, np.int64), stats
    if cfg.cd_dispatch == "graph":
        if not cfg.device_loop:
            raise ValueError(
                "cd_dispatch='graph' runs the whole CD phase on device "
                "and requires device_loop=True")
        subset_id, bounds, es = _receipt_wing_cd_graph(
            g, cfg, stats, device=dev, plan=plan)
    else:
        subset_id, bounds, es = receipt_wing_cd(g, cfg, stats, device=dev,
                                                plan=plan)
    psi_f = receipt_wing_fd(g, subset_id, bounds, cfg, stats, es,
                            device=dev, plan=plan)
    return np.round(psi_f).astype(np.int64), stats
