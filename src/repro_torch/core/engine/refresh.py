"""Subset-scoped prefix re-peel: the incremental-refresh engine entry
points (port of ``repro.core.engine.refresh``, DESIGN.md section 11).

After an edge-mutation batch, order it deletions first and apply the
witness-containment argument: every butterfly a mutation destroys or
creates contains the mutated edge's peeled-axis element (its U endpoint
on the vertex axis, the edge itself on the edge axis), so

* deletions change numbers only at levels <= the element's STORED number
  — a ceiling known before any device work;
* insertions change numbers only at levels <= the element's NEW number,
  certified during the re-peel: if the element peels below the stop, its
  exact new number is in hand; if it survives, the stop escalates to the
  next stored CD bound and the same device state keeps peeling.

So an exact refresh is one level peel from the delta-maintained supports
(``kernels.ops.vertex_support_edge_delta`` / ``edge_support_delta``),
stopped at the first bound of the ladder that clears the ceiling: peeled
elements get their exact new number (the ParButterfly min-peel argument,
``lo = 0``), survivors keep the stored one.

The loops are Python loops over device tensors with one read per sweep
(the loop test and the level's size together).  The tip loop gathers
the level's rows and launches kernel 1's peel body (kernel 4's on the
sparse backends, with the matrix's staircase extents), as the ParB path
does; the reference applies the mask form (B = A, s = the level) of the
same update.  The wing loop zeroes the level out of the carried
biadjacency and recounts every survivor in closed form.  Degree-sort
relabeling is skipped (the maintained supports and the stored numbers
live in canonical order).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...kernels import butterfly_sparse as ksparse
from ...kernels import ops as kops
from ...utils.spans import span
from ..graph import BipartiteGraph
from .peel_loop import (
    _INF,
    ReceiptConfig,
    RunStats,
    _zero_edges,
    apply_delta,
    bucket,
    fetch,
    level_threshold,
    peel_cost,
    peel_delta,
    record_theta,
    resolve_device,
    select_peel,
    upload,
)
from .wing import build_edge_state

__all__ = ["repeel_tip_prefix", "repeel_wing_prefix", "synthesize_bounds"]

# f32-finite stand-in for an unbounded stop (supports are integers far
# below this; padded-row supports are +inf and stay unpeelable)
_STOP_MAX = float(np.float32(3.0e38))
_F32 = torch.float32


def synthesize_bounds(numbers, num_partitions: int):
    """Coarse ascending CD-style bound ladder from COMPUTED peel numbers.

    ``Executor.map`` runs the whole-graph level schedule (``lo = 0``) and
    never builds Alg. 3's theta-range partition; the exact numbers in hand
    quantize into ``num_partitions`` equi-mass rungs, a valid stop ladder:
    strictly increasing, integral rungs, ``bounds[0] == 0`` and
    ``bounds[-1] > numbers.max()`` (the invariants
    ``verify_tip_decomposition`` checks).
    """
    th = np.asarray(numbers, np.float64).reshape(-1)
    t_max = float(th.max()) if th.size else 0.0
    interior = np.empty(0, np.float64)
    if th.size and int(num_partitions) > 1:
        qs = np.linspace(0.0, 1.0, int(num_partitions) + 1)[1:-1]
        interior = np.round(np.quantile(th, qs))
    rungs = np.unique(np.concatenate(
        [[0.0], interior, [t_max + 1.0]]))
    return [float(b) for b in rungs]


def _tip_prefix_loop(a, ids, row_ext, kmax, st: dict, hi_stop: float, *,
                     backend, blocks, max_sweeps, stats):
    """Level-peel every row whose tip number lands below ``hi_stop``
    (reference ``_tip_prefix_loop``): each sweep peels the whole
    current-minimum support level and applies its delta with the Alg. 2
    clamp, the level's rows gathered for the peel body.  Exits when every
    survivor's support is >= ``hi_stop`` or on the ``max_sweeps`` valve;
    ``st`` (support, alive, dv, theta, rho, wedges) is updated in place.
    """
    sweeps = 0
    while sweeps < max_sweeps:
        support, alive = st["support"], st["alive"]
        hi, cap = level_threshold(support, alive, 0.0)
        peel = select_peel(support, alive, hi)
        go, n_peel = fetch(stats, (alive & (support < hi_stop)).any(),
                           peel.sum())
        if not go:
            break
        delta = peel_delta(a, peel, int(n_peel), ids, row_ext, kmax,
                           backend=backend, blocks=blocks)
        colsum = peel.to(a.dtype) @ a
        st["wedges"] = st["wedges"] + peel_cost(colsum, st["dv"])
        st["support"], st["alive"] = apply_delta(support, alive, peel, delta,
                                                 cap)
        st["theta"] = record_theta(st["theta"], peel, cap)
        st["dv"] = st["dv"] - colsum
        st["rho"] += 1
        sweeps += 1


def _wing_prefix_loop(eu, ev, st: dict, hi_stop: float, *, backend, blocks,
                      max_sweeps, stats):
    """Edge-axis twin of ``_tip_prefix_loop`` (reference
    ``_wing_prefix_loop``): peel the level, zero it out of the carried
    biadjacency ``st["a"]`` (in place), recount every survivor in closed
    form, clamp at the sweep cap, stop at ``hi_stop``."""
    sweeps = 0
    while sweeps < max_sweeps:
        support, alive = st["support"], st["alive"]
        hi, cap = level_threshold(support, alive, 0.0)
        peel = select_peel(support, alive, hi)
        go, n_peel = fetch(stats, (alive & (support < hi_stop)).any(),
                           peel.sum())
        if not go:
            break
        colsum = _zero_edges(st["a"], eu, ev, peel)
        st["theta"] = record_theta(st["theta"], peel, cap)
        alive2 = alive & ~peel
        s2 = kops.edge_support_all(st["a"], eu, ev, backend=backend,
                                   blocks=blocks)
        st["support"] = torch.where(alive2, torch.maximum(s2, cap), _INF)
        st["alive"] = alive2
        st["dv"] = st["dv"] - colsum
        st["rho"] += 1
        st["wedges"] = st["wedges"] + float(n_peel)
        sweeps += 1


def _drain(run_one, stops: Sequence[float], watch: np.ndarray,
           alive0: np.ndarray, stats: RunStats):
    """Shared escalation driver (reference ``_drain``): drain the prefix
    loop at each candidate stop until every watched element is peeled (or
    the ladder is exhausted), carrying the device state across stops and
    cap exits.

    ``run_one(stop)`` runs one loop invocation at ``stop`` from the
    CURRENT carried state and returns the fetched ``(alive, theta, rho,
    support)`` host views (``rho`` the sweeps so far).  Returns
    ``(alive_h, th_acc, stop_used)``.
    """
    watch = np.asarray(watch, np.int64).reshape(-1)
    th_acc = np.zeros(alive0.shape, np.float64)
    prev_alive = alive0
    alive_h = alive0
    si = 0
    while True:
        stop = float(stops[si])
        alive_h, th_h, rho_h, sup_h = run_one(min(stop, _STOP_MAX))
        stats.device_loop_calls += 1
        newly_dead = prev_alive & ~alive_h
        th_acc = np.where(newly_dead, th_h, th_acc)
        prev_alive = alive_h
        if (alive_h & (sup_h < stop)).any() and rho_h > 0:
            continue                     # max_sweeps cap exit: re-enter
        if si + 1 < len(stops) and alive_h[watch].any():
            si += 1                      # a watched element survived: its
            continue                     # new number is >= stop — escalate
        stats.refresh_stop = stop
        return alive_h, th_acc, stop


def _carry(support0: np.ndarray, alive0: np.ndarray, dv, device,
           stats: RunStats) -> dict:
    """The prefix loops' carried state: supports (+inf where not alive),
    alive mask, residual degrees, theta, sweep and wedge counters (its
    uploads counted in ``stats.trace``)."""
    alive = upload(stats, alive0, device)
    sup = upload(stats, support0.astype(np.float32), device)
    return dict(support=torch.where(alive, sup, _INF), alive=alive, dv=dv,
                theta=torch.zeros(alive0.shape, dtype=_F32, device=device),
                rho=0, wedges=torch.zeros((), dtype=_F32, device=device))


def _run_one(loop, st: dict, stats: RunStats):
    """One prefix-loop invocation and the fetch ``_drain`` reads (the
    alive mask, theta and supports in one transfer)."""
    def run_one(stop):
        loop(st, stop)
        alive_h, th_h, sup_h = fetch(stats, st["alive"], st["theta"],
                                     st["support"])
        return alive_h.astype(bool), th_h, st["rho"], sup_h
    return run_one


def repeel_tip_prefix(
    g: BipartiteGraph, sup0: np.ndarray, theta_old: np.ndarray,
    stops: Sequence[float], watch: np.ndarray,
    cfg: Optional[ReceiptConfig] = None,
    stats: Optional[RunStats] = None, *, device=None, plan=None,
) -> Tuple[np.ndarray, float]:
    """Exact tip refresh of ``g`` (the POST-mutation graph, peeled side on
    U): level-peel from the maintained supports ``sup0``, stop at the
    first level of the ascending ladder ``stops`` that clears the
    mutation ceiling, keep ``theta_old`` for survivors.

    ``sup0`` must be the exact whole-graph butterfly supports of ``g`` and
    ``theta_old`` the pre-mutation tip numbers, both in canonical vertex
    order.  ``stops[0]`` must exceed the DELETION ceiling (max stored
    theta of the deleted edges' U endpoints); ``watch`` holds the
    INSERTED edges' U endpoints, whose new numbers certify the insertion
    ceiling — while any survives, the stop escalates to the next rung.
    ``device=None`` runs on the card.

    Returns ``(theta_new int64[n_u], stop_used)`` — bit-identical to a
    from-scratch decomposition of ``g``.  The span ``refresh.repeel``
    (``utils.spans``, on ``stats.trace``) times the whole call.
    """
    cfg = cfg or ReceiptConfig()
    stats = stats or RunStats()
    with span("refresh.repeel", stats):
        return _repeel_tip(g, sup0, theta_old, stops, watch, cfg, stats,
                           device=device, plan=plan)


def _repeel_tip(g, sup0, theta_old, stops, watch, cfg, stats, *, device,
                plan):
    dev = resolve_device(device)
    backend = kops.resolve_backend(cfg.backend, dev)
    blocks = cfg.kernel_blocks
    bi, bj, bk = blocks
    n_u = g.n_u

    # wedge-incapable V columns carry no butterflies; compact them away
    # exactly like the map-path ingest
    sub, _ = g.induced_on_u(np.arange(n_u), min_degree_v=2)
    rows_pad = bucket(max(n_u, 1), max(bi, bj))
    cols_pad = bucket(max(sub.n_v, 1), bk)
    if plan is not None:
        rows_pad = plan.quantize_dim("refresh_rows", rows_pad)
        cols_pad = plan.quantize_dim("refresh_cols", cols_pad)

    a = np.zeros((rows_pad, cols_pad), np.float32)
    a[sub.edges_u, sub.edges_v] = 1.0
    alive0 = np.arange(rows_pad) < n_u
    sup_pad = np.full(rows_pad, np.inf, np.float64)
    sup_pad[:n_u] = np.asarray(sup0, np.float64)[:n_u]
    a_dev = upload(stats, a, dev)
    ids = torch.arange(rows_pad, dtype=torch.int32, device=dev)
    if backend in kops.SPARSE_BACKENDS:
        row_ext = ksparse.row_extents_device(a_dev, bk)
        kmax = ksparse.tile_extents(row_ext, bi)
    else:
        row_ext = kmax = None
    st = _carry(sup_pad, alive0, a_dev.sum(dim=0), dev, stats)

    def loop(st_, stop):
        _tip_prefix_loop(a_dev, ids, row_ext, kmax, st_, stop,
                         backend=backend, blocks=blocks,
                         max_sweeps=cfg.max_sweeps, stats=stats)

    alive_h, th_acc, stop_used = _drain(_run_one(loop, st, stats), stops,
                                        watch, alive0, stats)
    stats.rho_fd += st["rho"]
    stats.wedges_fd += int(fetch(stats, st["wedges"])[0])
    theta_new = np.where(alive_h[:n_u],
                         np.asarray(theta_old, np.int64)[:n_u],
                         np.round(th_acc[:n_u]).astype(np.int64))
    return theta_new.astype(np.int64), stop_used


def repeel_wing_prefix(
    g: BipartiteGraph, sup0: np.ndarray, psi_old: np.ndarray,
    stops: Sequence[float], watch: np.ndarray,
    cfg: Optional[ReceiptConfig] = None,
    stats: Optional[RunStats] = None, *, device=None, plan=None,
) -> Tuple[np.ndarray, float]:
    """Edge-axis twin of ``repeel_tip_prefix``: exact wing refresh of
    ``g`` from maintained per-edge supports ``sup0`` (canonical edge order
    of ``g``), escalating through ``stops`` until every watched slot (the
    INSERTED edges) is peeled, with ``psi_old`` kept for survivors.
    ``stops[0]`` must exceed the deletion ceiling (max stored psi of the
    deleted edges).  Inserted edges carry any placeholder in ``psi_old``.

    Returns ``(psi_new int64[m], stop_used)`` — bit-identical to
    from-scratch.  The span ``refresh.repeel`` times the whole call.
    """
    cfg = cfg or ReceiptConfig()
    stats = stats or RunStats()
    with span("refresh.repeel", stats):
        return _repeel_wing(g, sup0, psi_old, stops, watch, cfg, stats,
                            device=device, plan=plan)


def _repeel_wing(g, sup0, psi_old, stops, watch, cfg, stats, *, device,
                 plan):
    dev = resolve_device(device)
    backend = kops.resolve_backend(cfg.backend, dev)
    blocks = cfg.kernel_blocks
    es = build_edge_state(g, cfg, device=dev, plan=plan)
    m, m_pad = es["m"], es["m_pad"]

    sup_pad = np.full(m_pad, np.inf, np.float64)
    sup_pad[:m] = np.asarray(sup0, np.float64)[:m]
    alive0 = es["alive0"]
    st = _carry(sup_pad, alive0, es["dv0"], dev, stats)
    st["a"] = es.pop("a")

    def loop(st_, stop):
        _wing_prefix_loop(es["eu"], es["ev"], st_, stop, backend=backend,
                          blocks=blocks, max_sweeps=cfg.max_sweeps,
                          stats=stats)

    alive_h, th_acc, stop_used = _drain(_run_one(loop, st, stats), stops,
                                        watch, alive0, stats)
    stats.rho_fd += st["rho"]
    stats.wedges_fd += int(fetch(stats, st["wedges"])[0])
    psi_new = np.where(alive_h[:m],
                       np.asarray(psi_old, np.int64)[:m],
                       np.round(th_acc[:m]).astype(np.int64))
    return psi_new.astype(np.int64), stop_used
