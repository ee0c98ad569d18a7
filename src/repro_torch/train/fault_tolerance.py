"""Fault tolerance and elasticity runtime (port of
``repro.train.fault_tolerance``).

* ``RestartManager`` — run-level restart policy over a
  ``CheckpointManager``: checkpoint cadence (``maybe_save``), resume from
  the newest complete step (``resume_or_init``), and the failure count
  against ``max_failures`` with a bounded failure log.  ``ckpt`` is
  optional: the service's background flush worker restarts through a
  manager without one.
* ``ElasticMesh`` — the largest ``("data", "model")`` mesh
  (``launch.mesh.DeviceMesh``) over the devices still healthy: the model
  axis is kept and dp shrinks, as in the reference.  A device's id is its
  position in the list.
* ``StragglerMonitor`` — a per-task timing EWMA; tasks slower than
  ``threshold x`` the median are flagged (``Executor.map`` feeds it one
  wall clock per chunk and marks the members of flagged chunks;
  ``launch.train.train_loop`` one per step).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["RestartManager", "ElasticMesh", "TaskTiming",
           "StragglerMonitor"]


@dataclasses.dataclass
class RestartManager:
    """Restart policy of a run: checkpoints every ``save_every`` steps
    through ``ckpt`` (a ``CheckpointManager``; the service passes
    ``None`` and uses the failure bookkeeping only), resume from the
    newest one, and a failure count against ``max_failures`` with a
    bounded failure log.
    """

    ckpt: Optional[Any] = None
    save_every: int = 100
    max_failures: int = 10
    # failure log bound: the newest entries win (a restart storm must not
    # grow host memory without bound)
    max_failure_log: int = 50

    failures: int = 0
    failure_log: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    def maybe_save(self, step: int, state: Any, *, blocking: bool = False):
        if step % self.save_every == 0 and step > 0:
            self.ckpt.save(step, state, blocking=blocking)

    def resume_or_init(self, template: Any, device=None,
                       init_fn: Optional[Callable] = None):
        """Returns (state, start_step): the newest checkpoint restored into
        ``template``'s structure on ``device`` (None: the card), or
        ``init_fn()`` (``template`` without one) and 0."""
        latest = self.ckpt.latest_step()
        if latest is None:
            state = init_fn() if init_fn is not None else template
            return state, 0
        state = self.ckpt.restore(template, step=latest, device=device)
        return state, latest

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


class ElasticMesh:
    """Mesh factory over a mutable healthy-device set."""

    def __init__(self, devices: Optional[Sequence] = None,
                 model_axis: int = 16):
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError("no CUDA device: pass devices=[...]")
            devices = [torch.device("cuda", i) for i in range(n)]
        self.devices = list(devices)
        self.failed: set = set()
        self.model_axis = model_axis

    def mark_failed(self, device_ids: Sequence[int]):
        self.failed.update(device_ids)

    def healthy(self) -> List:
        return [d for i, d in enumerate(self.devices) if i not in self.failed]

    def make_mesh(self):
        """Largest (dp, model) mesh from healthy devices.

        model axis stays at min(model_axis, n) and dp shrinks — losing a
        pod halves dp, preserving TP groups (which must stay intact for
        param shardings to remain valid shapes).
        """
        from ..launch.mesh import make_mesh

        devs = self.healthy()
        model = min(self.model_axis, len(devs))
        while model > 1 and len(devs) % model:
            model //= 2
        dp = len(devs) // model
        return make_mesh((dp, model), ("data", "model"),
                         devices=devs[: dp * model])


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
