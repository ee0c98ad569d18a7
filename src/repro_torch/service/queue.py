"""Request queue with admission control and per-dataset coalescing
(DESIGN.md §11); a copy of ``repro.service.queue``.

The queue holds DECOMPOSE WORK, not raw client requests: ingests and
mutations enqueue a ``WorkItem`` per dataset, and repeated submissions
for the same dataset COALESCE — a dataset's decomposition only ever
needs to run once against its latest graph version, so a pending
``"refresh"`` upgraded by a later ``"full"`` (or re-submitted at a newer
version) stays ONE item.  Admission control bounds the number of
distinct pending datasets (``max_pending``); beyond it, submission
raises ``ServiceUnavailableError`` instead of growing without bound.

Draining preserves first-submission order so ``Executor.map`` fleets
batch in arrival order (deterministic tests, fair service).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..api.errors import ServiceUnavailableError

__all__ = ["WorkItem", "RequestQueue"]

_KINDS = ("full", "refresh")


@dataclasses.dataclass
class WorkItem:
    """One unit of pending decompose work for one dataset.

    ``kind="full"`` forces a from-scratch decomposition;
    ``kind="refresh"`` permits the incremental path (which itself falls
    back to full past the dirty threshold).  ``version`` records the
    dataset's graph version at (re-)submission — informational; the
    worker always runs against the latest graph.
    """

    dataset: str
    kind: str
    version: int

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"WorkItem kind must be one of {_KINDS} (got "
                f"{self.kind!r})")


class RequestQueue:
    """FIFO of coalesced ``WorkItem``s, one per pending dataset."""

    def __init__(self, max_pending: int = 1024):
        self.max_pending = int(max_pending)
        self._items: Dict[str, WorkItem] = {}      # insertion-ordered
        self.submitted = 0
        self.coalesced = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._items)

    def pending(self, dataset: Optional[str] = None) -> bool:
        return (dataset in self._items if dataset is not None
                else bool(self._items))

    def submit(self, item: WorkItem) -> None:
        """Enqueue (or coalesce into) the dataset's pending item.

        Coalescing rule: ``full`` supersedes ``refresh`` (never the
        other way — a forced full must not degrade), and the recorded
        version advances to the latest submission's.
        """
        self.submitted += 1
        held = self._items.get(item.dataset)
        if held is not None:
            self.coalesced += 1
            if item.kind == "full":
                held.kind = "full"
            held.version = max(held.version, item.version)
            return
        if len(self._items) >= self.max_pending:
            self.rejected += 1
            raise ServiceUnavailableError(
                f"request queue at capacity ({self.max_pending} pending "
                "datasets); drain with flush() or raise "
                "ServiceConfig.max_pending", dataset=item.dataset)
        self._items[item.dataset] = item

    def drain(self, dataset: Optional[str] = None) -> List[WorkItem]:
        """Remove and return pending items in first-submission order —
        all of them, or just the named dataset's."""
        if dataset is not None:
            item = self._items.pop(dataset, None)
            return [item] if item is not None else []
        items = list(self._items.values())
        self._items.clear()
        return items

    def restore(self, items: List[WorkItem]) -> None:
        """Put drained-but-unfinished items BACK at the head of the
        queue, original order first (the scheduler's crash path: a
        worker cycle that dies mid-drain must not lose work).  Bypasses
        admission control — the items already held capacity — and
        coalesces with anything submitted since the drain."""
        tail = list(self._items.values())
        self._items.clear()
        for item in items + tail:
            held = self._items.get(item.dataset)
            if held is None:
                self._items[item.dataset] = item
                continue
            if item.kind == "full":
                held.kind = "full"
            held.version = max(held.version, item.version)
