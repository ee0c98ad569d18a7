"""Structured error taxonomy of the hardened runtime (DESIGN.md §7).

Every failure the decompose pipeline can produce is a ``ReceiptError``
carrying STRUCTURED context — the plan signature (the executable-cache
key), the CD dispatch mode, the subset or map-chunk the failure happened
in, the kernel backend that was running — so a service layer can route,
aggregate and retry failures without parsing message strings.

The taxonomy (one class per failure domain, ingestion -> results):

* ``GraphValidationError``   — malformed graph input (also a
  ``ValueError``: pre-hardening call sites raised ValueError, and
  ``except ValueError`` handlers keep working).
* ``PlanInfeasibleError``    — admission control rejected the plan (its
  padded-bytes estimate cannot fit the configured memory budget even
  after degrading to smaller FD groups).
* ``KernelBackendError``     — a kernel launch / device program failed
  (or a fault was injected at one); the Executor's fallback chain
  (``kernels.ops.fallback_backend``) catches exactly this.
* ``PeelOverflowError``      — the peel-buffer overflow replay exceeded
  its retry-with-widening bound (the buffer cannot grow past the padded
  row count; exceeding the bound means no progress is possible).
* ``VerificationError``      — ``decompose(verify=True)`` found a result
  violating the paper's invariants (theta containment at a subset
  boundary, support upper bound, bound monotonicity).
* ``FleetPartialFailure``    — ``Executor.map(strict=True)`` aggregate:
  per-graph errors for the failed fleet members, healthy count attached.

The serving layer (``repro.service``, DESIGN.md §11) extends the
taxonomy with three request-path classes:

* ``DatasetNotFoundError``   — query/mutation named a dataset the
  service does not hold (also a ``KeyError`` for dict-idiom handlers).
* ``StaleReadError``         — a ``staleness="strict"`` query hit a
  dataset whose graph version is ahead of its decomposition result.
* ``ServiceUnavailableError``— admission control rejected the request
  (queue at capacity, or the service cannot produce a result at all).
* ``ServiceWorkerError``     — the background flush worker crashed (or a
  ``refresh_worker`` fault was injected into it); carries the worker's
  cycle count and restart budget so operators can see where in the
  restart-with-backoff sequence the crash landed.

This module is deliberately LEAF-LEVEL: stdlib only, no jax, no numpy,
no repro imports — ``core/graph.py`` (numpy-only by contract) and the
kernel layer both import it without pulling the engine in.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = [
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
]

# context keys rendered in a stable order (everything else alphabetical)
_CTX_ORDER = ("plan_signature", "dispatch", "backend", "subset", "chunk",
              "graph_index", "site", "injected", "dataset", "version",
              "result_version", "cycle", "restarts")


class ReceiptError(Exception):
    """Base class: message + structured context.

    ``context`` holds every keyword the raise site attached (plan
    signature, dispatch mode, subset/chunk index, backend, injection
    site, ...); the rendered message appends it as ``[k=v ...]`` so logs
    stay greppable while handlers read attributes.
    """

    def __init__(self, message: str, **context: Any):
        self.message = message
        self.context: Dict[str, Any] = {
            k: v for k, v in context.items() if v is not None}
        super().__init__(self._render())

    def _render(self) -> str:
        if not self.context:
            return self.message
        keys = [k for k in _CTX_ORDER if k in self.context]
        keys += sorted(k for k in self.context if k not in _CTX_ORDER)
        ctx = " ".join(f"{k}={self._short(self.context[k])}" for k in keys)
        return f"{self.message} [{ctx}]"

    @staticmethod
    def _short(v: Any) -> str:
        s = repr(v)
        return s if len(s) <= 120 else s[:117] + "..."

    # convenience accessors for the context keys every layer attaches
    @property
    def plan_signature(self) -> Optional[tuple]:
        return self.context.get("plan_signature")

    @property
    def dispatch(self) -> Optional[str]:
        return self.context.get("dispatch")

    @property
    def injected(self) -> bool:
        return bool(self.context.get("injected", False))


class GraphValidationError(ReceiptError, ValueError):
    """Malformed graph input (NaN/inf/negative/non-binary dense matrix,
    zero-size side, out-of-range or non-parallel edge arrays)."""


class PlanInfeasibleError(ReceiptError, ValueError):
    """Admission control: the plan's padded-bytes estimate exceeds the
    configured device-memory budget and cannot be degraded under it."""


class KernelBackendError(ReceiptError, RuntimeError):
    """A kernel launch or device program failed (or an injected fault
    fired at one).  The port's backend chain is the backend alone: the
    Executor raises this naming it, and nothing is retried on another
    backend or quarantined."""


class PeelOverflowError(ReceiptError, RuntimeError):
    """The peel-buffer overflow replay exceeded its bounded
    retry-with-widening budget — the run cannot make progress."""


class VerificationError(ReceiptError):
    """A returned decomposition violates a RECEIPT invariant (theta
    containment at a subset boundary, initial-support upper bound, or
    bound monotonicity)."""


class FleetPartialFailure(ReceiptError):
    """``Executor.map(strict=True)``: some fleet members failed.

    ``errors`` maps the ORIGINAL graph index to that graph's
    ``ReceiptError``; ``n_ok`` counts the healthy members whose results
    were still produced (available via ``map(strict=False)``).
    """

    def __init__(self, message: str, *, errors: Dict[int, Exception],
                 n_ok: int, **context: Any):
        self.errors = dict(errors)
        self.n_ok = int(n_ok)
        detail = "; ".join(
            f"#{i}: {type(e).__name__}: {e}" for i, e in
            sorted(self.errors.items())[:4])
        if len(self.errors) > 4:
            detail += f"; ... {len(self.errors) - 4} more"
        super().__init__(
            f"{message}: {len(self.errors)} of {len(self.errors) + n_ok} "
            f"graph(s) failed ({detail})", **context)


class DatasetNotFoundError(ReceiptError, KeyError):
    """A service request named a dataset that was never ingested (or was
    dropped).  Also a ``KeyError`` so mapping-idiom handlers work.

    Note ``str(exc)`` goes through ``ReceiptError`` (the message, not
    KeyError's repr-of-args quoting).
    """

    def __str__(self) -> str:  # KeyError.__str__ would repr() the args
        return self._render()


class StaleReadError(ReceiptError):
    """A ``staleness="strict"`` query hit a dataset whose graph version
    is ahead of the version its cached decomposition was computed at.
    Context carries ``dataset``, ``version`` (graph) and
    ``result_version`` so callers can decide to retry after a flush."""


class ServiceUnavailableError(ReceiptError, RuntimeError):
    """The service cannot accept or fulfil the request right now —
    request queue at capacity (admission control), or no execution path
    can produce a result for the dataset."""


class ServiceWorkerError(ReceiptError, RuntimeError):
    """The background flush worker crashed — a real exception escaped a
    drain cycle, or a ``refresh_worker`` fault was injected into one.

    The scheduler restarts the worker with exponential backoff, bounded
    by a ``RestartManager``-style failure log; past the restart budget
    the worker stays down and the service degrades to inline
    draining.  Context carries ``site``, ``cycle`` and ``restarts``."""
