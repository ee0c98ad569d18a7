"""``DecompositionService`` — the request/response front of the serving
layer (DESIGN.md §11–§12; port of ``repro.service.core``).

Request lifecycle: **ingest/mutate** (validate, version-bump, enqueue,
wake the worker) → **drain cycle** (``scheduler.FlushScheduler``:
snapshot under the lock, classify routes, batch cross-dataset fleets,
compute OFF-lock, commit versioned results back) → **query** (answer
from the cached ``Decomposition`` under the staleness policy).

Two serving modes share all of that machinery:

* **inline** (the default): ``flush()`` — and a stale read under
  ``staleness="refresh"`` — runs a drain cycle on the calling thread.
* **background** (``ServiceConfig(background=True)`` or
  ``start_worker()``): a ``scheduler.FlushWorker`` thread drains the
  queue, so queries NEVER pay refresh wall — a stale read serves the
  last consistent version (with staleness metadata via
  ``query(..., with_info=True)``), and ``wait=True`` blocks on the
  freshness condition instead.  If the worker dies past its restart
  budget the service degrades back to inline draining.

Consistency: one re-entrant lock guards state transitions; the heavy
device work runs against SNAPSHOTS and commits whole
``(result, version, base_graph)`` triples, so readers racing an
in-flight refresh see the old version or the new one — never a torn
pair.  Cached state is governed by ``scheduler.CacheGovernor``
(LRU-with-pin eviction under ``ServiceConfig.cache_budget_bytes``;
evicted datasets recompute on demand).  Executors are shared per
workload across datasets, so fleets of same-shaped graphs hit one
signature cache.

Every executor runs on the service's device: the card unless the caller
passes ``device="cpu"`` (the plain versions of the kernels), and without
a card ``device=None`` raises, as ``Executor`` does.  Cached results are
host numpy, so serving one does no device work.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..api.config import EngineConfig
from ..api.errors import (
    DatasetNotFoundError,
    GraphValidationError,
    ServiceUnavailableError,
    StaleReadError,
)
from ..api.executor import Executor
from ..core.engine.peel_loop import resolve_device
from ..core.graph import BipartiteGraph
from .queue import RequestQueue, WorkItem
from .scheduler import CacheGovernor, FlushScheduler, FlushWorker
from .state import DatasetState, ServiceConfig

__all__ = ["DecompositionService"]


class DecompositionService:
    """Named, versioned decomposition datasets behind a query API.

    ``config`` is the base ``EngineConfig`` every dataset runs under
    (its ``workload`` field is overridden per dataset); ``service``
    carries the request-path knobs (``ServiceConfig``); ``device`` is
    where every executor runs (``None``: the card).
    """

    def __init__(self, config: Optional[EngineConfig] = None,
                 service: Optional[ServiceConfig] = None, *, device=None):
        self.device = resolve_device(device)
        self.engine_config = config or EngineConfig()
        self.service_config = service or ServiceConfig()
        self._datasets: Dict[str, DatasetState] = {}
        self._executors: Dict[str, Executor] = {}
        self._queue = RequestQueue(self.service_config.max_pending)
        self._lock = threading.RLock()
        # commits notify _fresh_cv (blocked readers / idle-waiters);
        # _exec_cv serializes drain cycles between worker and inline
        # flush callers via the _exec_busy flag
        self._fresh_cv = threading.Condition(self._lock)
        self._exec_cv = threading.Condition(self._lock)
        self._exec_busy = False
        self._governor = CacheGovernor(self.service_config.cache_budget_bytes)
        self._scheduler = FlushScheduler(self)
        self._worker: Optional[FlushWorker] = None
        self.last_flush_report: Optional[Dict] = None
        if self.service_config.background:
            self.start_worker()

    # ------------------------------------------------------------------ #
    # plumbing
    # ------------------------------------------------------------------ #
    def _executor(self, workload: str) -> Executor:
        with self._lock:
            ex = self._executors.get(workload)
            if ex is None:
                import dataclasses

                cfg = dataclasses.replace(self.engine_config,
                                          workload=workload)
                ex = Executor(cfg, device=self.device)
                self._executors[workload] = ex
            return ex

    def _get(self, name: str) -> DatasetState:
        ds = self._datasets.get(name)
        if ds is None:
            raise DatasetNotFoundError(
                f"dataset {name!r} was never ingested", dataset=name)
        return ds

    # ------------------------------------------------------------------ #
    # background worker lifecycle
    # ------------------------------------------------------------------ #
    @property
    def worker(self) -> Optional[FlushWorker]:
        return self._worker

    def start_worker(self) -> FlushWorker:
        """Start (or return the already-running) background flush
        worker; the fault spec on ``engine_config`` arms its
        ``refresh_worker`` site."""
        with self._lock:
            if self._worker is not None and self._worker.alive:
                return self._worker
            scfg = self.service_config
            self._worker = FlushWorker(
                self, poll_s=scfg.worker_poll_s,
                backoff_s=scfg.worker_backoff_s,
                max_restarts=scfg.worker_max_restarts,
                fault_spec=self.engine_config.fault_spec)
            self._worker.start()
            return self._worker

    def stop_worker(self, *, drain: bool = True,
                    timeout: float = 30.0) -> bool:
        """Cooperatively stop the worker (no-op without one); ``drain``
        finishes pending work first, ``drain=False`` abandons it in the
        queue (inline serving picks it up)."""
        w = self._worker
        if w is None:
            return True
        return w.stop(drain=drain, timeout=timeout)

    def _worker_alive(self) -> bool:
        w = self._worker
        return w is not None and w.alive

    def _wake_worker(self) -> None:
        w = self._worker
        if w is not None and w.alive:
            w.wake()

    def _notify_worker_death(self, exc) -> None:
        """Called from the worker thread when it exhausts its restart
        budget: wake every blocked reader so they fall back inline."""
        with self._lock:
            self._fresh_cv.notify_all()
            self._exec_cv.notify_all()

    def close(self) -> None:
        """Shut down: drain pending work through the worker if one
        runs, then stop it."""
        self.stop_worker(drain=True)

    def __enter__(self) -> "DecompositionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # ingestion
    # ------------------------------------------------------------------ #
    def ingest(self, name: str, graph=None, *, edges=None,
               n_u: Optional[int] = None, n_v: Optional[int] = None,
               workload: str = "tip", replace: bool = False) -> int:
        """Register (or replace) a named dataset and enqueue its
        decomposition.  Accepts a ``BipartiteGraph``, a dense 0/1
        biadjacency matrix (validated via ``from_dense``), or
        ``edges=(eu, ev)`` with ``n_u``/``n_v`` (via ``from_edges``).
        Returns the dataset's graph version (1 for a new dataset).
        """
        if workload not in ("tip", "wing"):
            raise ValueError(
                f"workload must be 'tip' or 'wing' (got {workload!r})")
        if graph is None:
            if edges is None or n_u is None or n_v is None:
                raise GraphValidationError(
                    "ingest needs a graph, a dense matrix, or "
                    "edges=(eu, ev) with n_u/n_v", dataset=name)
            eu, ev = edges
            g = BipartiteGraph.from_edges(n_u, n_v, eu, ev)
        elif isinstance(graph, BipartiteGraph):
            g = graph
        else:
            g = BipartiteGraph.from_dense(np.asarray(graph))
        with self._lock:
            if name in self._datasets and not replace:
                raise GraphValidationError(
                    f"dataset {name!r} already exists (pass replace=True "
                    "to overwrite)", dataset=name)
            old = self._datasets.get(name)
            version = (old.version + 1) if old is not None else 1
            ds = DatasetState(name=name, workload=workload, graph=g,
                              version=version)
            self._datasets[name] = ds
            self._governor.touch(ds)
            self._queue.submit(WorkItem(name, "full", ds.version))
        self._wake_worker()
        return version

    def drop(self, name: str) -> None:
        with self._lock:
            self._get(name)
            self._queue.drain(name)
            del self._datasets[name]

    def datasets(self) -> List[str]:
        with self._lock:
            return sorted(self._datasets)

    # ------------------------------------------------------------------ #
    # mutations (edge streams)
    # ------------------------------------------------------------------ #
    def insert_edges(self, name: str, eu, ev) -> int:
        """Insert an edge batch; returns the new graph version and
        enqueues an incremental refresh."""
        with self._lock:
            ds = self._get(name)
            v = ds.insert_edges(eu, ev)
            self._queue.submit(WorkItem(name, "refresh", v))
        self._wake_worker()
        return v

    def delete_edges(self, name: str, eu, ev) -> int:
        """Delete an edge batch; returns the new graph version and
        enqueues an incremental refresh."""
        with self._lock:
            ds = self._get(name)
            v = ds.delete_edges(eu, ev)
            self._queue.submit(WorkItem(name, "refresh", v))
        self._wake_worker()
        return v

    # ------------------------------------------------------------------ #
    # draining
    # ------------------------------------------------------------------ #
    def flush(self, name: Optional[str] = None, *,
              wait: bool = True) -> Optional[Dict]:
        """Drain pending work — all datasets, or one.

        Inline mode runs the drain cycle on the calling thread
        (``scheduler.FlushScheduler``: full-routed tip work batches
        through ONE ``Executor.map`` fleet, delta refreshes pack into
        LPT repeel fleets).  With the background worker alive the call
        delegates: wake the worker and (``wait=True``) block until the
        queue is idle.  Returns the last cycle report (also kept as
        ``last_flush_report``).
        """
        if self._worker_alive():
            self._wake_worker()
            if not wait:
                return self.last_flush_report
            if self.wait_until_idle(
                    timeout=self.service_config.wait_timeout_s):
                return self.last_flush_report
            if self._worker_alive():
                raise ServiceUnavailableError(
                    "flush timed out waiting for the background worker "
                    f"({self.service_config.wait_timeout_s:g}s)")
            # the worker died while we waited: drain inline below
        return self._scheduler.drain_and_run(name)

    def wait_until_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until no work is pending and no drain cycle is running
        (True), or the worker dies / ``timeout`` elapses (False)."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        with self._lock:
            while True:
                if not len(self._queue) and not self._exec_busy:
                    return True
                if not self._worker_alive():
                    return False
                self._wake_worker()
                step = 0.05
                if deadline is not None:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        return False
                    step = min(step, rem)
                self._fresh_cv.wait(step)

    # ------------------------------------------------------------------ #
    # query serving
    # ------------------------------------------------------------------ #
    def _serve(self, name: str, *, wait: bool = False,
               timeout: Optional[float] = None):
        """Resolve a dataset to a servable ``Decomposition`` under the
        staleness policy; counts hits (fresh-at-entry, no work ran).

        With the background worker alive a stale read NEVER pays
        refresh wall: it serves the last consistent version (counted in
        ``stale_reads``) while the worker refreshes; ``wait=True`` — or
        a dataset with no result yet, e.g. just ingested or evicted —
        blocks on the freshness condition instead (bounded by
        ``timeout`` / ``ServiceConfig.wait_timeout_s``).  The dataset
        is PINNED for the duration of a refresh this call waits on, so
        the governor cannot evict the answer before it is served.

        Returns ``(result, info)``, the info dict captured under the
        SAME lock hold that selected the result — the pair is
        consistent even while the worker commits concurrently.
        """
        scfg = self.service_config
        with self._lock:
            ds = self._get(name)
            ds.queries += 1
            self._governor.touch(ds)
            if ds.fresh:
                ds.query_hits += 1
                return ds.result, self._staleness_unlocked(ds)
            policy = scfg.staleness
            if policy == "strict" and not wait:
                raise StaleReadError(
                    f"dataset {name!r} is stale under staleness="
                    "'strict' — flush() first", dataset=name,
                    version=ds.version,
                    result_version=ds.result_version)
            if not self._queue.pending(name):
                # self-heal: evicted / errored datasets are stale with
                # no pending item to ride on
                kind = "refresh" if ds.result is not None else "full"
                try:
                    self._queue.submit(WorkItem(name, kind, ds.version))
                except ServiceUnavailableError:
                    pass
            if self._worker_alive() and not wait and ds.result is not None:
                ds.stale_reads += 1         # refresh runs in background
                self._wake_worker()
                return ds.result, self._staleness_unlocked(ds)
            if (not self._worker_alive() and policy == "stale_ok"
                    and ds.result is not None and not wait):
                ds.stale_reads += 1
                return ds.result, self._staleness_unlocked(ds)
            ds.pins += 1                    # answer survives until served
        try:
            with self._lock:
                if self._worker_alive():
                    self._wake_worker()
                    limit = (scfg.wait_timeout_s if timeout is None
                             else float(timeout))
                    deadline = time.monotonic() + limit
                    while not ds.fresh and self._worker_alive():
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            raise ServiceUnavailableError(
                                f"dataset {name!r} did not refresh "
                                f"within {limit:g}s (background worker "
                                "busy or stalled)", dataset=name,
                                version=ds.version,
                                result_version=ds.result_version)
                        self._wake_worker()
                        self._fresh_cv.wait(min(rem, 0.1))
                    if ds.fresh:
                        return ds.result, self._staleness_unlocked(ds)
                    # worker died mid-wait: fall through to inline
            # inline drain (no worker, or the worker died)
            self.flush(name)
            with self._lock:
                if ds.result is None:
                    raise ServiceUnavailableError(
                        f"dataset {name!r} has no decomposition result"
                        + (f" (last error: "
                           f"{type(ds.last_error).__name__}: "
                           f"{ds.last_error})" if ds.last_error else ""),
                        dataset=name, version=ds.version)
                return ds.result, self._staleness_unlocked(ds)
        finally:
            with self._lock:
                ds.pins = max(0, ds.pins - 1)
                self._governor.enforce(self._datasets)

    def query(self, name: str, *, wait: bool = False,
              timeout: Optional[float] = None, with_info: bool = False):
        """The dataset's current ``Decomposition`` (protocol object).

        ``wait=True`` blocks until the result is fresh (background
        mode); ``with_info=True`` returns ``(dec, info)`` where ``info``
        is the ``staleness_info`` dict describing exactly what was
        served — captured atomically with the result, so the pair never
        tears against a concurrent worker commit."""
        dec, info = self._serve(name, wait=wait, timeout=timeout)
        if not with_info:
            return dec
        return dec, info

    def _staleness_unlocked(self, ds: DatasetState) -> Dict:
        return {
            "dataset": ds.name,
            "version": ds.version,
            "result_version": ds.result_version,
            "fresh": ds.fresh,
            "stale_by": int(ds.version - ds.result_version),
            "pending": self._queue.pending(ds.name),
            "worker_alive": self._worker_alive(),
        }

    def staleness_info(self, name: str) -> Dict:
        """Explicit staleness metadata: graph vs result version, how
        many mutation batches behind the served result is, and whether
        a refresh is pending/in flight."""
        with self._lock:
            return self._staleness_unlocked(self._get(name))

    def tip_number(self, name: str, u: int) -> int:
        """Tip number of one peeled-side vertex (tip datasets)."""
        dec, _ = self._serve(name)
        if dec.workload != "tip":
            raise ServiceUnavailableError(
                f"tip_number queries a tip dataset; {name!r} is "
                f"{dec.workload!r}", dataset=name)
        return int(dec.numbers[u])

    def psi(self, name: str, e: int) -> int:
        """Wing number of one edge, canonical edge order (wing
        datasets)."""
        dec, _ = self._serve(name)
        if dec.workload != "wing":
            raise ServiceUnavailableError(
                f"psi queries a wing dataset; {name!r} is "
                f"{dec.workload!r}", dataset=name)
        return int(dec.numbers[e])

    def max_theta(self, name: str) -> int:
        """Deprecated alias of ``max_level``."""
        return self.max_level(name)

    def max_level(self, name: str) -> int:
        return self._serve(name)[0].max_level()

    def subgraph_at(self, name: str, k: float):
        """The k-dense hierarchy cut of the dataset (tip: k-tip with
        member/column ids; wing: k-wing with surviving edge ids)."""
        return self._serve(name)[0].subgraph_at(k)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    def describe(self) -> str:
        """Config endpoint: resolved engine knobs + service knobs +
        dataset inventory."""
        scfg = self.service_config
        lines = [self.engine_config.describe(), "ServiceConfig"]
        lines.append(f"  staleness:        {scfg.staleness!r}")
        lines.append(f"  dirty threshold:  "
                     f"{scfg.refresh_dirty_threshold:g}")
        lines.append(f"  max pending:      {scfg.max_pending}")
        lines.append(f"  map min fleet:    {scfg.map_min_fleet}")
        lines.append(f"  background:       "
                     f"{'on' if self._worker_alive() else 'off'}")
        budget = scfg.cache_budget_bytes
        lines.append(f"  cache budget:     "
                     f"{budget if budget is not None else 'unbounded'}")
        with self._lock:
            lines.append(f"datasets ({len(self._datasets)})")
            for nm in sorted(self._datasets):
                s = self._datasets[nm].summary()
                lines.append(
                    f"  {nm}: {s['workload']} "
                    f"{s['n_u']}x{s['n_v']} m={s['m']} "
                    f"v{s['version']}"
                    + ("" if s["fresh"] else
                       f" (result v{s['result_version']})"))
        return "\n".join(lines)

    def cache_report(self) -> Dict:
        """The memory governor's accounting: budget, cached bytes per
        dataset, pins, LRU order, eviction counts."""
        with self._lock:
            return self._governor.report(self._datasets)

    def report(self) -> Dict:
        """Counters: per-dataset serving stats + queue accounting +
        per-workload executor cache stats + worker / cache state."""
        with self._lock:
            w = self._worker
            return {
                "datasets": {nm: ds.summary()
                             for nm, ds in self._datasets.items()},
                "queue": {
                    "pending": len(self._queue),
                    "submitted": self._queue.submitted,
                    "coalesced": self._queue.coalesced,
                    "rejected": self._queue.rejected,
                },
                "executors": {wl: ex.cache_stats
                              for wl, ex in self._executors.items()},
                "worker": (w.report() if w is not None else None),
                "cache": self._governor.report(self._datasets),
            }
