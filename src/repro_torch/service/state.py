"""Service-side state: the frozen ``ServiceConfig`` and the per-dataset
``DatasetState`` (DESIGN.md §11); a copy of ``repro.service.state``.

A dataset is DIFF-DRIVEN: mutations replace the current graph (built and
validated through ``BipartiteGraph.from_edges``) and bump ``version``;
no mutation log is kept.  At refresh time the insert/delete sets are
recovered as set differences between the current graph and
``base_graph`` (the graph the cached result was computed on) — edge
keys are canonical ``u * n_v + v``, so both diffs are two sorted-array
operations.  This makes redundant mutations (insert then delete the
same edge) free and keeps the refresh ceiling tied to the NET change.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..api.errors import GraphValidationError
from ..core.graph import BipartiteGraph

__all__ = ["ServiceConfig", "DatasetState", "edge_keys"]

_STALENESS = ("refresh", "stale_ok", "strict")


def edge_keys(g: BipartiteGraph) -> np.ndarray:
    """Canonical sorted edge keys (``u * n_v + v``, int64) — the
    currency every diff/alignment in the refresh path trades in."""
    return g.edges_u.astype(np.int64) * g.n_v + g.edges_v.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Frozen serving-layer knobs (the engine knobs live in
    ``EngineConfig``; these govern the request path only).

    * ``refresh_dirty_threshold`` — net changed-edge fraction above
      which a refresh falls back to full recompute (the delta path's
      per-mutation cost stops paying for itself).
    * ``max_pending`` — request-queue admission bound; submits beyond
      it raise ``ServiceUnavailableError``.
    * ``staleness`` — what a query does when the dataset's graph
      version is ahead of its result version: ``"refresh"`` drains the
      pending work first (default), ``"stale_ok"`` serves the stale
      result and counts it, ``"strict"`` raises ``StaleReadError``.
    * ``map_min_fleet`` — minimum number of compatible pending full
      tip decomposes before a flush batches them through
      ``Executor.map`` instead of per-graph ``decompose``.
    * ``background`` — start the scheduler's flush worker at service
      construction; queries then serve the last consistent version and
      never pay refresh wall (DESIGN.md §12).
    * ``cache_budget_bytes`` — the serving-side ``MemoryBudget``: total
      bytes of cached results/supports/ladders the ``CacheGovernor``
      may hold before LRU-with-pin eviction kicks in (``None`` =
      unbounded).
    * ``repeel_fleet_cells`` — cell budget one cross-dataset repeel
      fleet is packed under (mirrors ``Executor.map_stack_cells``).
    * ``worker_poll_s`` / ``worker_backoff_s`` / ``worker_max_restarts``
      — flush-worker heartbeat, crash-restart backoff base, and the
      restart budget (bounded by the ``RestartManager`` failure log).
    * ``wait_timeout_s`` — bound on ``query(..., wait=True)`` blocking.
    """

    refresh_dirty_threshold: float = 0.05
    max_pending: int = 1024
    staleness: str = "refresh"
    map_min_fleet: int = 2
    background: bool = False
    cache_budget_bytes: Optional[int] = None
    repeel_fleet_cells: int = 1 << 26
    worker_poll_s: float = 0.05
    worker_backoff_s: float = 0.02
    worker_max_restarts: int = 3
    wait_timeout_s: float = 120.0

    def __post_init__(self):
        if not 0.0 <= float(self.refresh_dirty_threshold) <= 1.0:
            raise ValueError(
                f"refresh_dirty_threshold must be in [0, 1] (got "
                f"{self.refresh_dirty_threshold}); it is a fraction of "
                "the dataset's edge count")
        if int(self.max_pending) < 1:
            raise ValueError(
                f"max_pending must be >= 1 (got {self.max_pending})")
        if self.staleness not in _STALENESS:
            raise ValueError(
                f"staleness must be one of {_STALENESS} (got "
                f"{self.staleness!r})")
        if int(self.map_min_fleet) < 2:
            raise ValueError(
                f"map_min_fleet must be >= 2 (got {self.map_min_fleet}); "
                "a fleet of one is a plain decompose")
        if self.cache_budget_bytes is not None \
                and int(self.cache_budget_bytes) < 1:
            raise ValueError(
                f"cache_budget_bytes must be >= 1 or None (got "
                f"{self.cache_budget_bytes}); 0 would evict every commit")
        if int(self.repeel_fleet_cells) < 1:
            raise ValueError(
                f"repeel_fleet_cells must be >= 1 (got "
                f"{self.repeel_fleet_cells})")
        if not float(self.worker_poll_s) > 0.0:
            raise ValueError(
                f"worker_poll_s must be > 0 (got {self.worker_poll_s})")
        if float(self.worker_backoff_s) < 0.0:
            raise ValueError(
                f"worker_backoff_s must be >= 0 (got "
                f"{self.worker_backoff_s})")
        if int(self.worker_max_restarts) < 0:
            raise ValueError(
                f"worker_max_restarts must be >= 0 (got "
                f"{self.worker_max_restarts})")
        if not float(self.wait_timeout_s) > 0.0:
            raise ValueError(
                f"wait_timeout_s must be > 0 (got {self.wait_timeout_s})")


@dataclasses.dataclass
class DatasetState:
    """One named dataset: current graph + versioning + cached result +
    the refresh bookkeeping.

    ``version`` counts graph states (bumped by ingest and every
    mutation batch); ``result_version`` is the graph version the cached
    ``result`` was computed at — ``result_version == version`` means
    fresh.  ``supports`` caches the peeled-axis whole-graph butterfly
    supports of ``base_graph`` for the tip delta path (primed lazily on
    the first delta refresh, then maintained incrementally); ``bounds``
    are the CD subset bounds of the last full run — the refresh stop
    ladder.  Single-graph runs store the real CD ladder; ``Executor.map``
    fleet results store the equi-mass ladder synthesized from the exact
    theta (``core.engine.refresh.synthesize_bounds``), so a mapped
    result's first refresh can still stop early instead of peeling one
    ``[inf]`` rung.
    """

    name: str
    workload: str                    # "tip" | "wing"
    graph: BipartiteGraph
    version: int = 1
    base_graph: Optional[BipartiteGraph] = None
    result: Optional[object] = None  # api.Decomposition once computed
    result_version: int = 0
    supports: Optional[np.ndarray] = None
    bounds: Optional[List[float]] = None
    last_error: Optional[Exception] = None
    # counters (surfaced by DecompositionService.report())
    queries: int = 0
    query_hits: int = 0
    stale_reads: int = 0
    refreshes: int = 0
    full_recomputes: int = 0
    # cache-governor bookkeeping (DESIGN.md §12): LRU clock value of the
    # last touch, in-flight-refresh pin count (pinned datasets are never
    # evicted), evictions suffered
    last_access: int = 0
    pins: int = 0
    evictions: int = 0

    # ------------------------------------------------------------------ #
    # mutations (diff-driven: build + validate the new graph, bump)
    # ------------------------------------------------------------------ #
    def insert_edges(self, eu, ev) -> int:
        """Insert an edge batch; every edge must be absent.  Returns the
        new graph version."""
        eu = np.asarray(eu, np.int64).reshape(-1)
        ev = np.asarray(ev, np.int64).reshape(-1)
        if eu.size != ev.size:
            raise GraphValidationError(
                f"insert_edges endpoint arrays differ in length "
                f"({eu.size} vs {ev.size})", dataset=self.name)
        add = BipartiteGraph.from_edges(self.graph.n_u, self.graph.n_v,
                                        eu, ev)          # range-validated
        if add.m != eu.size:
            raise GraphValidationError(
                f"insert_edges batch contains duplicate edges "
                f"({eu.size - add.m} dropped by canonicalization)",
                dataset=self.name)
        cur = edge_keys(self.graph)
        new = edge_keys(add)
        present = np.isin(new, cur)
        if present.any():
            i = int(np.nonzero(present)[0][0])
            raise GraphValidationError(
                f"insert_edges: edge ({add.edges_u[i]}, {add.edges_v[i]}) "
                f"already present ({int(present.sum())} of {new.size} "
                "duplicates)", dataset=self.name)
        keys = np.sort(np.concatenate([cur, new]))
        self.graph = BipartiteGraph.from_edges(
            self.graph.n_u, self.graph.n_v,
            keys // self.graph.n_v, keys % self.graph.n_v)
        self.version += 1
        return self.version

    def delete_edges(self, eu, ev) -> int:
        """Delete an edge batch; every edge must be present.  Returns
        the new graph version."""
        eu = np.asarray(eu, np.int64).reshape(-1)
        ev = np.asarray(ev, np.int64).reshape(-1)
        if eu.size != ev.size:
            raise GraphValidationError(
                f"delete_edges endpoint arrays differ in length "
                f"({eu.size} vs {ev.size})", dataset=self.name)
        drop = BipartiteGraph.from_edges(self.graph.n_u, self.graph.n_v,
                                         eu, ev)
        cur = edge_keys(self.graph)
        gone = edge_keys(drop)
        missing = ~np.isin(gone, cur)
        if missing.any():
            i = int(np.nonzero(missing)[0][0])
            raise GraphValidationError(
                f"delete_edges: edge ({drop.edges_u[i]}, "
                f"{drop.edges_v[i]}) not present "
                f"({int(missing.sum())} of {gone.size} missing)",
                dataset=self.name)
        keys = np.setdiff1d(cur, gone)
        self.graph = BipartiteGraph.from_edges(
            self.graph.n_u, self.graph.n_v,
            keys // self.graph.n_v, keys % self.graph.n_v)
        self.version += 1
        return self.version

    # ------------------------------------------------------------------ #
    def commit(self, result, *, bounds=None, supports=None) -> None:
        """Install a decomposition computed at the CURRENT graph
        version (full run or refresh)."""
        self.commit_at(result, version=self.version, graph=self.graph,
                       bounds=bounds, supports=supports)

    def commit_at(self, result, *, version: int, graph: BipartiteGraph,
                  bounds=None, supports=None) -> bool:
        """Install a decomposition computed at a SNAPSHOT of this
        dataset (the background scheduler computes off-lock against a
        copy; the live graph may have moved on).  The result/base pair
        stays internally consistent — ``result`` was computed on
        ``graph`` at ``version`` — so a reader never sees a torn pair.
        Returns False (and installs nothing) when a newer result is
        already in place."""
        if self.result is not None and version < self.result_version:
            return False
        self.result = result
        self.result_version = int(version)
        self.base_graph = graph
        self.bounds = bounds
        self.supports = supports
        self.last_error = None
        return True

    def evict_cache(self) -> None:
        """Drop every cached derived artifact (result, supports, CD
        ladder, base graph) — the dataset degrades to recompute-on-
        demand; the CURRENT graph and its version are never evicted, so
        a later query recomputes the exact same answers."""
        self.result = None
        self.result_version = 0
        self.base_graph = None
        self.supports = None
        self.bounds = None
        self.evictions += 1

    def cached_bytes(self) -> int:
        """Evictable bytes this dataset holds: the cached numbers
        vector, the maintained supports, the stop ladder, and the base
        graph's edge arrays when it differs from the live graph (fresh
        datasets alias the two)."""
        n = 0
        if self.result is not None:
            n += np.asarray(self.result.numbers).nbytes
        if self.supports is not None:
            n += np.asarray(self.supports).nbytes
        if self.bounds is not None:
            n += 8 * len(self.bounds)
        if self.base_graph is not None and self.base_graph is not self.graph:
            n += self.base_graph.edges_u.nbytes + \
                self.base_graph.edges_v.nbytes
        return int(n)

    @property
    def fresh(self) -> bool:
        return self.result is not None and \
            self.result_version == self.version

    def summary(self) -> dict:
        return {
            "workload": self.workload,
            "n_u": int(self.graph.n_u), "n_v": int(self.graph.n_v),
            "m": int(self.graph.m),
            "version": self.version,
            "result_version": self.result_version,
            "fresh": self.fresh,
            "queries": self.queries, "query_hits": self.query_hits,
            "stale_reads": self.stale_reads,
            "refreshes": self.refreshes,
            "full_recomputes": self.full_recomputes,
            "cached_bytes": self.cached_bytes(),
            "evictions": self.evictions,
        }
