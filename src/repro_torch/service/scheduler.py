"""``repro_torch.service.scheduler`` — WHEN and HOW decomposition work
runs (DESIGN.md §12; a copy of ``repro.service.scheduler``, but for
where a drain cycle classifies its routes).

Draining the refresh queue inline, on the first stale read, under the
service lock is correct, but the query path then pays the refresh wall
and cached state grows without bound.  This module owns the execution
policy behind the request path, in three pieces:

* ``FlushScheduler`` — one DRAIN CYCLE: snapshot the stale datasets
  under the lock, then OFF-LOCK classify each snapshot's route host-side
  (``refresh.classify_refresh``; it sorts the edge keys, milliseconds at
  full size that readers and mutators would otherwise wait on — the
  reference classifies under the lock) and run the device work against
  the snapshots, and commit each finished result back under the lock as
  a consistent ``(result, result_version, base_graph)`` triple
  (``DatasetState.commit_at``).  Readers racing a cycle always see
  either the old consistent version or the new one — never a torn pair.
  Admission batching is cross-dataset and cross-kind: every
  ``"full"``-routed tip job in the cycle (forced fulls AND refreshes
  past the dirty threshold) joins ONE ``Executor.map`` fleet, and the
  ``"delta"`` routes pack into LPT-ordered repeel fleets under a cell
  budget (``ServiceConfig.repeel_fleet_cells``) — the same
  workload-aware machinery (``core.scheduler.lpt_assign``) the engine
  fleets use.

* ``FlushWorker`` — the background thread that calls the scheduler so
  QUERIES NEVER PAY REFRESH WALL: mutations enqueue work and wake the
  worker; reads serve the last consistent version with staleness
  metadata (``DecompositionService.query(..., with_info=True)``) and
  ``wait=True`` opts into blocking on the ``_fresh_cv`` condition.
  Shutdown is cooperative: ``stop(drain=True)`` finishes the queue
  first, ``drain=False`` abandons it (items stay queued for inline
  service).  On the card the worker's launches go to its thread's
  current stream (the default stream); a CUDA fault that PyTorch raises
  there is no ``ReceiptError``, so it escapes the cycle and is counted
  as a crash, while a refused launch (``KernelBackendError``) is the
  job's own error (``last_error``, the cycle report's ``errors``).  The worker is a FAULT DOMAIN: a ``refresh_worker``
  injection point fires at the top of each cycle, crashes surface as
  structured ``ServiceWorkerError``, and the worker restarts with
  exponential backoff bounded by a ``RestartManager`` failure log —
  past the budget it stays down and the service degrades to inline
  draining (graceful, never wrong).

* ``CacheGovernor`` — the serving-side ``MemoryBudget``: per-dataset
  byte accounting of every evictable artifact (cached numbers vector,
  maintained supports, CD stop ladder, diff base graph) against
  ``ServiceConfig.cache_budget_bytes``, with LRU-with-pin eviction.  A
  cycle PINS its datasets before releasing the lock, so in-flight
  refresh inputs are never evicted underneath the compute; an evicted
  dataset keeps its live graph + version and degrades to
  recompute-on-demand — never to wrong answers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional

from ..api import faults
from ..api.errors import ReceiptError, ServiceUnavailableError, \
    ServiceWorkerError
from ..core.scheduler import lpt_assign
from ..train.fault_tolerance import RestartManager
from ..utils.spans import span
from .queue import WorkItem
from .refresh import classify_refresh, refresh_dataset
from .state import DatasetState

__all__ = ["FlushScheduler", "FlushWorker", "CacheGovernor"]


# --------------------------------------------------------------------- #
# memory governor
# --------------------------------------------------------------------- #
class CacheGovernor:
    """LRU-with-pin eviction of cached decomposition state under a byte
    budget (the serving layer's ``MemoryBudget``).

    Accounting is DERIVED, not tracked: ``DatasetState.cached_bytes()``
    sums the evictable artifacts on demand, so the governor can never
    drift from the state it governs.  ``touch`` advances a monotone
    clock per access (queries and commits both touch); ``enforce``
    evicts the least-recently-used UNPINNED dataset until the total fits
    the budget — when everything evictable is pinned by an in-flight
    cycle the governor stays over budget rather than corrupt the cycle's
    inputs (pins are short-lived; the next enforce catches up).
    """

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget_bytes = (None if budget_bytes is None
                             else int(budget_bytes))
        self._clock = 0
        self.evicted_total = 0

    def touch(self, ds: DatasetState) -> None:
        self._clock += 1
        ds.last_access = self._clock

    def enforce(self, datasets: Dict[str, DatasetState],
                report: Optional[Dict] = None) -> List[str]:
        """Evict until the cached total fits the budget; returns the
        evicted dataset names (also appended to ``report["evicted"]``).
        Caller holds the service lock."""
        if self.budget_bytes is None:
            return []
        evicted: List[str] = []
        while True:
            total = sum(ds.cached_bytes() for ds in datasets.values())
            if total <= self.budget_bytes:
                break
            victims = [ds for ds in datasets.values()
                       if ds.pins == 0 and ds.cached_bytes() > 0]
            if not victims:
                break              # all pinned: over budget, never wrong
            lru = min(victims, key=lambda d: d.last_access)
            lru.evict_cache()
            self.evicted_total += 1
            evicted.append(lru.name)
        if report is not None and evicted:
            report.setdefault("evicted", []).extend(evicted)
        return evicted

    def report(self, datasets: Dict[str, DatasetState]) -> Dict:
        """The ``cache_report()`` payload: budget, totals, per-dataset
        bytes / pin / LRU position / evictions."""
        per = {nm: {"cached_bytes": ds.cached_bytes(),
                    "pinned": ds.pins > 0,
                    "last_access": ds.last_access,
                    "evictions": ds.evictions,
                    "fresh": ds.fresh}
               for nm, ds in datasets.items()}
        total = sum(v["cached_bytes"] for v in per.values())
        return {
            "budget_bytes": self.budget_bytes,
            "cached_bytes": total,
            "over_budget": (self.budget_bytes is not None
                            and total > self.budget_bytes),
            "evicted_total": self.evicted_total,
            "datasets": per,
        }


# --------------------------------------------------------------------- #
# one drain cycle
# --------------------------------------------------------------------- #
class _Job:
    """One drained work item bound to its dataset snapshot."""

    __slots__ = ("name", "item", "live", "copy", "route", "workload",
                 "produced", "committed")

    def __init__(self, item: WorkItem, live: DatasetState,
                 copy: DatasetState, route: str):
        self.name = item.dataset
        self.item = item
        self.live = live                 # identity witness for commit
        self.copy = copy                 # compute runs against this
        self.route = route
        self.workload = live.workload
        self.produced = False            # a result/version-sync landed
        self.committed = False           # commit step ran (even if error)


class FlushScheduler:
    """Drains the request queue and runs the work — snapshot under the
    lock, compute off-lock, commit versioned results back.

    One cycle at a time: ``service._exec_busy`` (guarded by the service
    lock, waited on via ``_exec_cv``) serializes cycles between the
    background worker and inline ``flush()`` callers, while queries and
    mutations proceed under the lock the compute is NOT holding.
    """

    def __init__(self, service):
        self._svc = service

    # -- entry point --------------------------------------------------- #
    def drain_and_run(self, name: Optional[str] = None, *,
                      background: bool = False) -> Dict:
        """One drain cycle (class docstring) under the span ``flush``,
        its phases under ``flush.prepare``, ``flush.run`` and
        ``flush.commit`` (profiler ranges only)."""
        with span("flush"):
            return self._cycle(name, background)

    def _cycle(self, name: Optional[str], background: bool) -> Dict:
        svc = self._svc
        report = {"items": 0, "mapped": 0, "fleets": 0,
                  "repeel_fleets": 0, "refreshed": 0, "full": 0,
                  "errors": 0, "requeued": 0, "dropped": 0,
                  "evicted": [], "background": bool(background)}
        with svc._lock:
            while svc._exec_busy:
                svc._exec_cv.wait()
            items = svc._queue.drain(name)
            if not items:
                svc.last_flush_report = report
                svc._fresh_cv.notify_all()     # idle-waiters recheck
                return report
            svc._exec_busy = True
            with span("flush.prepare"):
                jobs = self._prepare(items, report)
        done = False
        try:
            with span("flush.run"):
                self._run(jobs, report)
            done = True
        finally:
            with svc._lock:
                for job in jobs:
                    job.live.pins = max(0, job.live.pins - 1)
                if not done:
                    # a crash mid-cycle must not lose work: unfinished
                    # items go back to the head of the queue
                    svc._queue.restore([j.item for j in jobs
                                        if not j.committed])
                svc._governor.enforce(svc._datasets, report)
                svc._exec_busy = False
                svc.last_flush_report = report
                svc._exec_cv.notify_all()
                svc._fresh_cv.notify_all()
        return report

    # -- phase 1: snapshot (under the service lock) --------------------- #
    def _prepare(self, items: List[WorkItem], report: Dict) -> List[_Job]:
        svc = self._svc
        report["items"] = len(items)
        jobs: List[_Job] = []
        for it in items:
            ds = svc._datasets.get(it.dataset)
            if ds is None:                       # dropped meanwhile
                continue
            job = _Job(it, ds, dataclasses.replace(ds), route="")
            ds.pins += 1                         # in-flight inputs pinned
            jobs.append(job)
        return jobs

    # -- phase 2: classify + run off-lock, committing as each finishes - #
    def _run(self, jobs: List[_Job], report: Dict) -> None:
        scfg = self._svc.service_config
        for job in jobs:
            # the snapshot holds the graph pair the live dataset had at
            # the drain (mutations replace graphs, never edit them), so
            # its route is the one classified under the lock would be
            job.route = classify_refresh(
                job.copy, scfg, force_full=(job.item.kind == "full"))
        fleet = [j for j in jobs
                 if j.route == "full" and j.workload == "tip"]
        if len(fleet) >= scfg.map_min_fleet:
            self._run_map_fleet(fleet, report)
            rest = [j for j in jobs if not j.committed]
        else:
            rest = list(jobs)
        deltas = [j for j in rest if j.route == "delta"]
        for job in (j for j in rest if j.route != "delta"):
            self._run_single(job, report)
        for pack in self._pack_repeel_fleets(deltas, scfg):
            report["repeel_fleets"] += 1
            for job in pack:
                self._run_single(job, report)

    def _run_map_fleet(self, fleet: List[_Job], report: Dict) -> None:
        """Every full-routed tip job in the cycle — forced fulls and
        refreshes that would fall back anyway — as ONE ``Executor.map``
        fleet (LPT chunking + the shared executable cache)."""
        svc = self._svc
        ex = svc._executor("tip")
        results = ex.map([j.copy.graph for j in fleet], strict=False)
        report["fleets"] += 1
        for job, res in zip(fleet, results):
            if isinstance(res, ReceiptError):
                job.copy.last_error = res
                report["errors"] += 1
            else:
                bounds = (list(res.stats.bounds)
                          if getattr(res.stats, "bounds", None) else None)
                job.copy.commit(res, bounds=bounds, supports=None)
                job.produced = True
                report["mapped"] += 1
            self._commit(job, report)

    def _run_single(self, job: _Job, report: Dict) -> None:
        svc = self._svc
        ex = svc._executor(job.workload)
        try:
            stats = refresh_dataset(job.copy, ex, svc.service_config,
                                    force_full=(job.item.kind == "full"))
            job.produced = True
        except ReceiptError as exc:
            job.copy.last_error = exc
            report["errors"] += 1
        else:
            if stats is not None:
                if stats.refresh_mode == "delta":
                    report["refreshed"] += 1
                else:
                    report["full"] += 1
        self._commit(job, report)

    @staticmethod
    def _pack_repeel_fleets(deltas: List[_Job], scfg) -> List[List[_Job]]:
        """LPT-pack delta refreshes into fleets under the cell budget —
        heavy datasets first, fleets balanced by padded-cell mass."""
        if not deltas:
            return []
        weights = [float(j.copy.graph.n_u) * float(j.copy.graph.n_v)
                   for j in deltas]
        n = max(1, min(len(deltas),
                       int(math.ceil(sum(weights)
                                     / float(scfg.repeel_fleet_cells)))))
        return [[deltas[i] for i in idxs]
                for idxs in lpt_assign(weights, n) if idxs]

    # -- phase 3: versioned commit (under the service lock) ------------ #
    def _commit(self, job: _Job, report: Dict) -> None:
        with span("flush.commit"):
            svc = self._svc
            job.committed = True
            with svc._lock:
                live = svc._datasets.get(job.name)
                if live is not job.live:             # dropped or replaced
                    report["dropped"] += 1
                    return
                copy = job.copy
                if job.produced and copy.result is not None:
                    # consistent (result, version, base graph) triple from
                    # the snapshot — the LIVE graph may already be ahead
                    live.commit_at(copy.result, version=copy.result_version,
                                   graph=copy.base_graph, bounds=copy.bounds,
                                   supports=copy.supports)
                live.refreshes = copy.refreshes
                live.full_recomputes = copy.full_recomputes
                live.last_error = copy.last_error
                svc._governor.touch(live)
                if (job.produced and live.result is not None
                        and live.version > live.result_version
                        and not svc._queue.pending(job.name)):
                    # a mutation raced the compute: keep the dataset queued
                    with contextlib.suppress(ServiceUnavailableError):
                        svc._queue.submit(
                            WorkItem(job.name, "refresh", live.version))
                        report["requeued"] += 1
                svc._governor.enforce(svc._datasets, report)
                svc._fresh_cv.notify_all()


# --------------------------------------------------------------------- #
# the background flush worker
# --------------------------------------------------------------------- #
class FlushWorker:
    """Thread that drains the service queue so queries never pay
    refresh wall; crash-isolated with restart-with-backoff.

    Lifecycle: ``start()`` spawns a daemon thread that waits on a wake
    event (mutations and queries set it) with a ``poll_s`` heartbeat,
    and runs one ``FlushScheduler.drain_and_run`` cycle per wakeup.
    ``stop(drain=True)`` finishes pending work before exiting;
    ``drain=False`` abandons it in the queue.

    Fault domain: ``faults.fault_point("refresh_worker", ...)`` fires at
    the top of each cycle (armed via ``EngineConfig.fault_spec`` — the
    worker scopes its own injector on its thread, since ``inject()``
    scopes are thread-local — or the process-wide ``RECEIPT_FAULT``
    env).  Any exception escaping a cycle is recorded in a bounded
    ``RestartManager`` failure log; the worker restarts after an
    exponential backoff until ``max_restarts`` failures, then marks
    itself dead and wakes every blocked reader so the service degrades
    to inline draining.
    """

    def __init__(self, service, *, poll_s: float = 0.05,
                 backoff_s: float = 0.02, max_restarts: int = 3,
                 fault_spec: Optional[str] = None,
                 name: str = "receipt-flush-worker"):
        self._svc = service
        self.poll_s = float(poll_s)
        self.backoff_s = float(backoff_s)
        self.restarts = RestartManager(ckpt=None,
                                       max_failures=int(max_restarts))
        self._injector = (faults.FaultInjector(fault_spec)
                          if fault_spec else None)
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead = False
        self._drain_on_stop = True
        self.name = name
        self.cycles = 0
        self.crashes = 0
        self.last_error: Optional[ServiceWorkerError] = None

    # -- lifecycle ----------------------------------------------------- #
    @property
    def alive(self) -> bool:
        t = self._thread
        return (t is not None and t.is_alive() and not self._dead
                and not self._stop.is_set())

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()

    def wake(self) -> None:
        self._wake.set()

    def stop(self, *, drain: bool = True, timeout: float = 30.0) -> bool:
        """Cooperative shutdown; returns True when the thread exited
        within ``timeout``.  ``drain`` finishes the queue first."""
        self._drain_on_stop = bool(drain)
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def report(self) -> Dict:
        return {
            "alive": self.alive,
            "dead": self._dead,
            "cycles": self.cycles,
            "crashes": self.crashes,
            "restarts": self.restarts.failures,
            "max_restarts": self.restarts.max_failures,
            "failure_log": self.restarts.failure_report(),
            "last_error": (str(self.last_error)
                           if self.last_error else None),
        }

    # -- the loop ------------------------------------------------------ #
    def _run(self) -> None:
        # inject() scopes are thread-local: the spec armed on the
        # service's config must be scoped HERE, on the worker thread,
        # for refresh_worker rules to see it (env arming is process-wide
        # and needs no scope)
        scope = (faults.inject(self._injector)
                 if self._injector is not None
                 else contextlib.nullcontext())
        backoff = self.backoff_s
        with scope:
            while True:
                self._wake.wait(self.poll_s)
                self._wake.clear()
                stopping = self._stop.is_set()
                try:
                    if not stopping or self._drain_on_stop:
                        self.cycles += 1
                        faults.fault_point(
                            "refresh_worker", ServiceWorkerError,
                            "injected background-worker death",
                            cycle=self.cycles,
                            restarts=self.restarts.failures)
                        self._svc._scheduler.drain_and_run(
                            background=True)
                    backoff = self.backoff_s
                except Exception as exc:       # noqa: BLE001 — fault domain
                    self.crashes += 1
                    if isinstance(exc, ServiceWorkerError):
                        err = exc
                    else:
                        err = ServiceWorkerError(
                            f"background flush worker crashed: "
                            f"{type(exc).__name__}: {exc}",
                            site="refresh_worker", cycle=self.cycles,
                            restarts=self.restarts.failures)
                    self.last_error = err
                    if not self.restarts.record_failure(err):
                        self._dead = True      # budget exhausted: stay down
                        self._svc._notify_worker_death(err)
                        return
                    if stopping:               # crash during final drain:
                        self._wake.set()       # retry after backoff
                    if backoff > 0:
                        time.sleep(backoff)
                    backoff = min(max(backoff, 1e-3) * 2.0, 2.0)
                    continue
                if stopping:
                    return
