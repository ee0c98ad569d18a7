"""`repro_torch.api` — the plan/execute service layer, the port's entry
point (port of ``repro.api``, tip workload).

1. **Ingestion** — ``repro_torch.core.graph.BipartiteGraph.from_edges`` /
   ``from_dense``; ``EngineConfig`` (frozen, serializable, strictly
   validated) selects the peeled side and every engine knob.
2. **Planning** — ``Planner.plan(graph) -> ExecutionPlan``: dispatch
   mode, bucketed shapes, kernel route, FD shape-group estimates, the
   representation (dense or tiled) and a padded-bytes estimate, checked
   against ``EngineConfig.memory_budget_bytes``.
3. **Execution** — ``Executor`` runs plans through a cache keyed by the
   plan's signature (measured sizing reused across same-shaped graphs) and
   batches fleets of small graphs (``Executor.map``); results are
   ``TipDecomposition`` objects.

The hardened runtime: ``errors`` (the ``ReceiptError`` taxonomy),
``faults`` (deterministic fault injection), fleet isolation in
``Executor.map`` and ``decompose(verify=True)``.  Entry points run on the
card unless given ``device="cpu"``::

    from repro_torch.api import EngineConfig, Executor
    ex = Executor(EngineConfig(num_partitions=32))       # the card
    td = ex.decompose(g)
    td.theta, td.max_theta(), td.subgraph_at(5)

The wing workload (``WingDecomposition``, ``verify_wing_decomposition``)
arrives with the wing slice.  This initializer is LAZY (PEP 562): the
stdlib-only ``errors`` and ``faults`` modules are imported by the engine
and the kernel layer, and must not pull the executor in.
"""
from __future__ import annotations

import importlib

__all__ = [
    "EngineConfig",
    "ExecutionPlan",
    "Planner",
    "Executor",
    "Decomposition",
    "TipDecomposition",
    "decompose",
    "verify_tip_decomposition",
    "ReceiptError",
    "GraphValidationError",
    "PlanInfeasibleError",
    "KernelBackendError",
    "PeelOverflowError",
    "VerificationError",
    "FleetPartialFailure",
    "DatasetNotFoundError",
    "StaleReadError",
    "ServiceUnavailableError",
    "ServiceWorkerError",
    "FaultInjector",
    "FaultSpec",
    "errors",
    "faults",
]

_LAZY = {
    "EngineConfig": "config",
    "ExecutionPlan": "plan",
    "Planner": "plan",
    "Executor": "executor",
    "Decomposition": "executor",
    "TipDecomposition": "executor",
    "decompose": "executor",
    "verify_tip_decomposition": "executor",
    "ReceiptError": "errors",
    "GraphValidationError": "errors",
    "PlanInfeasibleError": "errors",
    "KernelBackendError": "errors",
    "PeelOverflowError": "errors",
    "VerificationError": "errors",
    "FleetPartialFailure": "errors",
    "DatasetNotFoundError": "errors",
    "StaleReadError": "errors",
    "ServiceUnavailableError": "errors",
    "ServiceWorkerError": "errors",
    "FaultInjector": "faults",
    "FaultSpec": "faults",
}


def __getattr__(name: str):
    if name in ("errors", "faults"):
        return importlib.import_module(f".{name}", __name__)
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(__all__) | set(globals()))
