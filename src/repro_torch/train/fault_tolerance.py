"""Restart bookkeeping and straggler detection (copies of
``RestartManager``, ``TaskTiming`` and ``StragglerMonitor`` from
``repro.train.fault_tolerance``, whose module imports jax).

``RestartManager`` keeps the failure count and a bounded failure log
(the service's background flush worker restarts through it);
``StragglerMonitor`` keeps a per-task timing EWMA; tasks slower than
``threshold x`` the median are flagged (``Executor.map`` feeds it one wall
clock per chunk and marks the members of flagged chunks).
``ElasticMesh`` (model training over a shrinking mesh) waits for the model
substrate (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["RestartManager", "TaskTiming", "StragglerMonitor"]


@dataclasses.dataclass
class RestartManager:
    """Failure bookkeeping of a restartable run: a failure count against
    ``max_failures`` and a bounded failure log.

    ``ckpt`` is the checkpoint manager of a training run; the service
    passes ``None``.  The reference's ``maybe_save`` and
    ``resume_or_init`` (and ``save_every``, their cadence) arrive with
    the port's ``train/checkpoint.py``.
    """

    ckpt: Optional[Any] = None
    max_failures: int = 10
    # failure log bound: the newest entries win (a restart storm must not
    # grow host memory without bound)
    max_failure_log: int = 50

    failures: int = 0
    failure_log: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    def record_failure(self, exc: BaseException) -> bool:
        """Returns True if the run should restart, False to abort.

        Every failure is appended to a BOUNDED log (type, truncated
        message, wall-clock time) so a post-mortem can reconstruct the
        restart history without the manager growing without bound."""
        self.failures += 1
        self.failure_log.append(dict(
            type=type(exc).__name__,
            message=str(exc)[:512],
            time=time.time(),
        ))
        if len(self.failure_log) > self.max_failure_log:
            del self.failure_log[: len(self.failure_log)
                                 - self.max_failure_log]
        return self.failures <= self.max_failures

    def failure_report(self) -> List[Dict[str, Any]]:
        """The bounded failure log, oldest first (copies — safe to
        mutate)."""
        return [dict(e) for e in self.failure_log]


@dataclasses.dataclass
class TaskTiming:
    ewma: float = 0.0
    n: int = 0

    def update(self, dt: float, alpha: float = 0.3):
        self.ewma = dt if self.n == 0 else (1 - alpha) * self.ewma + alpha * dt
        self.n += 1


class StragglerMonitor:
    """Flags tasks whose runtime exceeds ``threshold x`` the median EWMA."""

    def __init__(self, threshold: float = 2.0):
        self.threshold = threshold
        self.timings: Dict[Any, TaskTiming] = {}

    def record(self, task_id: Any, dt: float):
        self.timings.setdefault(task_id, TaskTiming()).update(dt)

    def stragglers(self) -> List[Any]:
        if len(self.timings) < 3:
            return []
        ew = {k: t.ewma for k, t in self.timings.items() if t.n > 0}
        med = float(np.median(list(ew.values())))
        if med <= 0:
            return []
        return [k for k, v in ew.items() if v > self.threshold * med]

    def speculative_plan(self, pending: Sequence, k_workers: int):
        """LPT-pack pending tasks; duplicate flagged stragglers onto the
        least-loaded worker (first-finisher wins, the other is cancelled)."""
        from ..core.scheduler import lpt_assign

        weights = [self.timings.get(t, TaskTiming()).ewma or 1.0
                   for t in pending]
        plan = lpt_assign(weights, k_workers)
        strag = set(self.stragglers())
        dups = [i for i, t in enumerate(pending) if t in strag]
        if dups and plan:
            loads = [sum(weights[i] for i in w) for w in plan]
            target = int(np.argmin(loads))
            for i in dups:
                if i not in plan[target]:
                    plan[target].append(i)
        return plan
