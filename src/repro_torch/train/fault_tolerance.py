"""Straggler detection (copy of ``TaskTiming`` and ``StragglerMonitor``
from ``repro.train.fault_tolerance``, whose module imports jax).

``StragglerMonitor`` keeps a per-task timing EWMA; tasks slower than
``threshold x`` the median are flagged (``Executor.map`` feeds it one wall
clock per chunk and marks the members of flagged chunks).  The restart
manager and the elastic mesh arrive with the service and distributed
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np

__all__ = ["TaskTiming", "StragglerMonitor"]


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
