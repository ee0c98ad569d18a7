"""`repro_torch.service` — decomposition-as-a-service over
`repro_torch.api` (DESIGN.md §11–§12; port of `repro.service`).

The serving layer turns the plan/compile/execute stack into a
long-lived, queryable system:

* **ingestion** (``DecompositionService.ingest``) — graphs and edge
  streams become named, versioned datasets (validated through
  ``BipartiteGraph.from_edges`` / ``from_dense``);
* **request queue with admission batching** (``queue.RequestQueue``) —
  pending decompose requests coalesce per dataset; the drain cycle
  (``scheduler.FlushScheduler``) batches full-routed tip work into ONE
  ``Executor.map`` fleet and packs delta refreshes into LPT repeel
  fleets under a cell budget;
* **query serving** — ``tip_number`` / ``psi`` / ``subgraph_at`` /
  ``max_level`` answered from the cached ``Decomposition`` under a
  per-dataset version pair (graph version vs result version) and a
  configurable staleness policy;
* **incremental refresh** (``refresh.refresh_dataset``) — edge
  insert/delete updates butterfly supports through the delta kernels
  and re-peels only the CD subsets the mutation ceiling reaches
  (``core.engine.refresh``), falling back to full recompute past the
  dirty-fraction threshold;
* **background scheduling + memory governance**
  (``scheduler.FlushWorker`` / ``scheduler.CacheGovernor``) — an
  optional flush worker drains the queue off the query path (stale
  reads return the last consistent version instantly, with explicit
  staleness metadata; ``wait=True`` opts into blocking), and cached
  results live under a byte budget with LRU-with-pin eviction
  (evicted datasets recompute on demand — degraded, never wrong).

The service runs on the card unless given ``device="cpu"``::

    from repro_torch.api import EngineConfig
    from repro_torch.service import DecompositionService, ServiceConfig
    svc = DecompositionService(EngineConfig(num_partitions=150),
                               ServiceConfig(background=True))
    svc.ingest("g", graph)
    svc.insert_edges("g", eu, ev)
    dec, info = svc.query("g", with_info=True)
"""
from .core import DecompositionService
from .queue import RequestQueue, WorkItem
from .refresh import classify_refresh, refresh_dataset
from .scheduler import CacheGovernor, FlushScheduler, FlushWorker
from .state import DatasetState, ServiceConfig

__all__ = [
    "DecompositionService",
    "ServiceConfig",
    "DatasetState",
    "RequestQueue",
    "WorkItem",
    "refresh_dataset",
    "classify_refresh",
    "FlushScheduler",
    "FlushWorker",
    "CacheGovernor",
]
