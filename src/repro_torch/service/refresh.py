"""Incremental-refresh orchestration (DESIGN.md §11; port of
``repro.service.refresh``).

``refresh_dataset`` is the service's worker for one stale dataset: it
recovers the net insert/delete sets from the base/current graph diff,
maintains the peeled-axis butterfly supports through the delta kernels,
builds the stop ladder from the stored CD bounds, and hands
``Executor.repeel`` the bounded prefix peel — falling back to a full
``Executor.decompose`` when the delta path cannot win (no prior result,
dirty fraction over the threshold, tiled-routed plan, empty endpoint
graphs) or when it fails (any ``ReceiptError``).  The fallback IS the
degradation story: a refresh never errors out of the service, it just
recomputes.

Every tensor lives on the executor's device: the union matrix is built
there by scattering the edge ids into a zero matrix, and the delta ops
run on the executor's kernel route (kernel 1's count body on ``"cuda"``,
kernel 4's on ``"cuda_sparse"``, their plain versions on the CPU).  What
a refresh needs on the host comes back in ONE blocking read, added to the
run's ``RunStats.host_round_trips``, as float64 numpy, so the maintained
supports (``DatasetState.supports``) are the reference's to the byte.

A delta refresh is one run: ``refresh_dataset`` makes its ``RunStats``
first and hands it to ``Executor.repeel``, so that its spans land there
(``utils.spans``): ``flush.route`` (the route and the key differences),
``refresh.delta`` (the union matrix, the support prime or deltas, their
read and the ladder), then the engine's ``refresh.repeel``; the uploads
of the edge ids count in its ``trace``.

Support maintenance per axis:

* **tip** — pure delta: ``vertex_support_edge_delta`` on the union
  matrix with the insert rows gives per-vertex gains, with the delete
  rows gives losses; ``B_new = B_base + gains - losses``, sequentially
  exact.  ``B_base`` is primed lazily on the first delta refresh, by the
  counting op on the device (the reference primes with a host float64
  product), and then carried incrementally.  The prime is exact in the
  engine's f32 integer regime (supports below 2^24, DESIGN.md §8); a
  prime at or past it raises ``PlanInfeasibleError``, so that the
  dataset is recomputed in full.
* **wing** — the union supports come from ONE closed-form
  ``edge_support_all`` recount (the edge axis's always-available HUC
  arm): the delta op does not report an inserted edge's own support.
  Deletions then ride ``edge_support_delta`` — ``B_new = B_union -
  d_del`` at the kept slots, where the delta is exact (it differs from
  the reference's only on the removed slots themselves, which are
  dropped).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..api.errors import PlanInfeasibleError, ReceiptError
from ..api.executor import TipDecomposition, WingDecomposition
from ..core.engine.peel_loop import RunStats, fetch, upload
from ..kernels import ops as kops
from ..utils.spans import span
from .state import DatasetState, ServiceConfig, edge_keys

__all__ = ["refresh_dataset", "classify_refresh", "tip_supports"]

# supports are integers carried in f32 by the counting kernels: exact
# below 2^24 (DESIGN.md section 8)
EXACT_LIMIT = float(2 ** 24)


def _route(executor):
    """The executor's kernel route: (backend, blocks)."""
    return (kops.resolve_backend(executor.config.backend, executor.device),
            executor.config.kernel_blocks)


def _matrix(n_u: int, n_v: int, eu, ev, device, stats=None) -> torch.Tensor:
    """The (n_u, n_v) f32 0/1 matrix with ones at ``(eu, ev)``, built on
    ``device`` by a scatter into zeros."""
    a = torch.zeros((n_u, n_v), dtype=torch.float32, device=device)
    _scatter(a, eu, ev, stats)
    return a


def _scatter(a: torch.Tensor, eu, ev, stats) -> None:
    a[upload(stats, np.asarray(eu, np.int64), a.device),
      upload(stats, np.asarray(ev, np.int64), a.device)] = 1.0


def _read(stats: RunStats, parts) -> List[np.ndarray]:
    """The refresh's one blocking read, timed as a ``read`` of the
    cycle's run; the caller counts it in ``host_round_trips`` beside the
    re-peel's own reads."""
    with span("read", stats):
        return fetch(None, *parts)


def tip_supports(a: torch.Tensor, *, backend=None,
                 blocks=kops.DEFAULT_BLOCKS) -> torch.Tensor:
    """Whole-graph per-row butterfly supports of the 0/1 matrix ``a`` on
    its device, f32 (the counting op: kernel 1's count body, kernel 4's
    on the sparse backends, whose extents are ``a``'s own)."""
    backend = kops.resolve_backend(backend, a.device)
    kmax = None
    if backend in kops.SPARSE_BACKENDS:
        from ..kernels.butterfly_sparse import column_extents

        kmax = column_extents(a, blocks[0], blocks[2]).to(torch.int32)
    ones = torch.ones(a.shape[0], dtype=torch.float32, device=a.device)
    return kops.butterfly_support(a, ones, backend=backend, blocks=blocks,
                                  kmax=kmax)


def _ladder(bounds: Optional[List[float]], floor: float) -> List[float]:
    """Ascending stop candidates strictly above ``floor`` (integer
    levels, so "+0.5" separates), ending in ``inf`` — the rung every
    ladder can always escalate to (a whole-graph level peel from the
    maintained supports: exact, still skips counting + CD)."""
    rungs = sorted({float(b) for b in (bounds or [])
                    if float(b) > floor + 0.5})
    rungs.append(float("inf"))
    return rungs


def _mark_subsets(stats, bounds: Optional[List[float]]) -> None:
    """Refresh evidence: a stored CD subset ``s`` (theta range
    ``[bounds[s], bounds[s+1])``) is re-peeled iff its range starts
    below the stop; everything above is CLEAN and kept verbatim."""
    if bounds and len(bounds) >= 2:
        total = len(bounds) - 1
        repeeled = sum(1 for s in range(total)
                       if bounds[s] < stats.refresh_stop)
    else:
        total, repeeled = 1, 1
    stats.refresh_subsets_total = total
    stats.refresh_subsets_repeeled = repeeled


def _full(ds: DatasetState, executor, *, fallback: bool):
    dec = executor.decompose(ds.graph)
    stats = dec.stats
    if fallback:
        stats.refresh_mode = "full"
    ds.full_recomputes += 1
    bounds = list(stats.bounds) if getattr(stats, "bounds", None) else None
    ds.commit(dec, bounds=bounds, supports=None)
    return stats


def _tip_delta(ds: DatasetState, executor, kI: np.ndarray, kD: np.ndarray,
               stats: RunStats):
    base, cur = ds.base_graph, ds.graph
    with span("refresh.delta", stats):
        n_v = base.n_v
        iu, iv = kI // n_v, kI % n_v
        du, dv = kD // n_v, kD % n_v
        if executor.side == "V":
            gb = base.transposed()
            iu, iv, du, dv = iv, iu, dv, du
        else:
            gb = base
        backend, blocks = _route(executor)
        dev = executor.device
        a = _matrix(gb.n_u, gb.n_v, gb.edges_u, gb.edges_v, dev, stats)
        prime = ds.supports is None
        parts = ([tip_supports(a, backend=backend, blocks=blocks)] if prime
                 else [])
        _scatter(a, iu, iv, stats)           # union matrix = base + inserts
        for ru, rv in ((iu, iv), (du, dv)):
            if ru.size:
                parts.append(kops.vertex_support_edge_delta(
                    a, upload(stats, ru, dev), upload(stats, rv, dev),
                    torch.ones(ru.size, dtype=torch.bool, device=dev),
                    backend=backend, blocks=blocks))
        del a                                # the re-peel builds its own
        host = _read(stats, parts)
        if prime:
            ds.supports = host.pop(0)
            top = float(ds.supports.max(initial=0.0))
            if top >= EXACT_LIMIT:
                raise PlanInfeasibleError(
                    f"butterfly support {top:.0f} is past the f32 integer "
                    "regime (2^24, DESIGN.md section 8): the maintained "
                    "supports cannot be primed exactly — refresh by full "
                    "recompute instead", dispatch="refresh")
        gains = host.pop(0) if kI.size else 0.0
        losses = host.pop(0) if kD.size else 0.0
        sup_new = np.asarray(ds.supports, np.float64) + gains - losses

        numbers_old = np.asarray(ds.result.numbers, np.int64)
        # deletion ceiling is certified by stored numbers; the insert
        # endpoints' stored numbers only SEED the ladder higher (fewer
        # escalations when their level won't have dropped) — correctness
        # comes from the watch set, not the seed
        t_known = float(numbers_old[du].max()) if kD.size else 0.0
        seed = max(t_known,
                   float(numbers_old[iu].max()) if kI.size else 0.0)
        stops = _ladder(ds.bounds, seed)
        watch = np.unique(iu)
    numbers_new, stats = executor.repeel(
        cur, sup0=sup_new, numbers_old=numbers_old, stops=stops,
        watch=watch, stats=stats)
    stats.host_round_trips += 1
    stats.refresh_dirty_edges = int(kI.size + kD.size)
    ceil = t_known
    if watch.size:
        ceil = max(ceil, float(numbers_new[watch].max()))
    stats.refresh_t_hi = ceil
    _mark_subsets(stats, ds.bounds)
    dec = TipDecomposition(graph=cur, side=executor.side,
                           theta=numbers_new, stats=stats, plan=None)
    ds.refreshes += 1
    ds.commit(dec, bounds=ds.bounds, supports=sup_new)
    return stats


def _wing_delta(ds: DatasetState, executor, kI: np.ndarray, kD: np.ndarray,
                stats: RunStats):
    base, cur = ds.base_graph, ds.graph
    with span("refresh.delta", stats):
        n_v = base.n_v
        k_base = edge_keys(base)
        k_cur = edge_keys(cur)
        ku = np.sort(np.concatenate([k_base, kI]))
        backend, blocks = _route(executor)
        dev = executor.device
        a = _matrix(base.n_u, n_v, ku // n_v, ku % n_v, dev, stats)
        eu_dev = upload(stats, ku // n_v, dev)
        ev_dev = upload(stats, ku % n_v, dev)
        parts = [kops.edge_support_all(a, eu_dev, ev_dev, backend=backend,
                                       blocks=blocks)]
        if kD.size:
            del_slots = upload(stats, np.searchsorted(ku, kD), dev)
            parts.append(kops.edge_support_delta(
                a, eu_dev, ev_dev, del_slots,
                torch.ones(kD.size, dtype=torch.bool, device=dev),
                backend=backend, blocks=blocks))
        del a
        host = _read(stats, parts)
        b_union = host[0]
        d_del = host[1] if kD.size else 0.0
        kept = np.isin(ku, k_cur)          # ku and k_cur both sorted: aligned
        sup_new = (b_union - d_del)[kept]

        psi_base = np.asarray(ds.result.numbers, np.int64)
        psi_old = np.zeros(cur.m, np.int64)        # inserts: placeholder —
        in_base = np.isin(k_cur, k_base)           # always peeled via watch
        psi_old[in_base] = psi_base[np.searchsorted(k_base, k_cur[in_base])]
        t_known = (float(psi_base[np.searchsorted(k_base, kD)].max())
                   if kD.size else 0.0)
        stops = _ladder(ds.bounds, t_known)
        watch = np.nonzero(np.isin(k_cur, kI))[0]
    numbers_new, stats = executor.repeel(
        cur, sup0=sup_new, numbers_old=psi_old, stops=stops, watch=watch,
        stats=stats)
    stats.host_round_trips += 1
    stats.refresh_dirty_edges = int(kI.size + kD.size)
    ceil = t_known
    if watch.size:
        ceil = max(ceil, float(numbers_new[watch].max()))
    stats.refresh_t_hi = ceil
    _mark_subsets(stats, ds.bounds)
    dec = WingDecomposition(graph=cur, side=executor.side,
                            edge_wing=numbers_new, stats=stats, plan=None)
    ds.refreshes += 1
    ds.commit(dec, bounds=ds.bounds, supports=None)
    return stats


def classify_refresh(ds: DatasetState, scfg: ServiceConfig, *,
                     force_full: bool = False) -> str:
    """Route one stale dataset WITHOUT doing device work: ``"noop"``
    (already fresh, or a net no-op mutation sequence), ``"full"``
    (from-scratch decompose — forced, no prior result, or past the
    dirty threshold) or ``"delta"`` (the incremental path).

    The scheduler uses this to batch: every ``"full"``-routed tip
    dataset in a drain cycle — forced fulls AND refreshes that would
    fall back anyway — joins one ``Executor.map`` fleet, and the
    ``"delta"`` routes pack into LPT-ordered repeel fleets.
    """
    if ds.fresh and not force_full:
        return "noop"
    if force_full or ds.result is None or ds.base_graph is None:
        return "full"
    k_base = edge_keys(ds.base_graph)
    k_cur = edge_keys(ds.graph)
    kI = np.setdiff1d(k_cur, k_base)
    kD = np.setdiff1d(k_base, k_cur)
    if not kI.size and not kD.size:
        return "noop"
    dirty = (kI.size + kD.size) / max(ds.base_graph.m, 1)
    if (dirty > scfg.refresh_dirty_threshold
            or ds.base_graph.m == 0 or ds.graph.m == 0):
        return "full"
    return "delta"


def refresh_dataset(ds: DatasetState, executor,
                    scfg: ServiceConfig, *, force_full: bool = False):
    """Bring ``ds.result`` up to ``ds.version``; returns the run's
    ``RunStats`` (or None when the dataset was already fresh).

    Routing (``classify_refresh``): delta refresh when a prior result +
    base graph exist, the net dirty fraction is within
    ``scfg.refresh_dirty_threshold`` and both endpoint graphs are
    non-degenerate; full recompute otherwise (and on ANY
    ``ReceiptError`` from the delta path — e.g. a plan that routed to
    the tiled representation, which the dense refresh loops reject as
    ``PlanInfeasibleError``, or a support prime past the f32 integer
    regime).
    """
    stats = RunStats()
    with span("flush.route", stats):
        route = classify_refresh(ds, scfg, force_full=force_full)
        if route == "delta":
            k_cur, k_base = edge_keys(ds.graph), edge_keys(ds.base_graph)
            kI = np.setdiff1d(k_cur, k_base)
            kD = np.setdiff1d(k_base, k_cur)
    if route == "noop":
        if not ds.fresh and ds.result is not None:
            # net no-op mutation sequence: the stored result IS current
            ds.result_version = ds.version
            ds.base_graph = ds.graph
        return None
    if route == "full":
        # fallback=True marks the runs the DELTA path declined (dirty
        # fraction, degenerate endpoints) — a forced full or a first
        # decompose is not a fallback
        fallback = not (force_full or ds.result is None
                        or ds.base_graph is None)
        return _full(ds, executor, fallback=fallback)
    try:
        if ds.workload == "wing":
            return _wing_delta(ds, executor, kI, kD, stats)
        return _tip_delta(ds, executor, kI, kD, stats)
    except ReceiptError as exc:
        ds.last_error = exc
        return _full(ds, executor, fallback=True)
