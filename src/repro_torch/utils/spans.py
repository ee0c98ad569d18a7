"""Spans and counters of the port's runs.

``span(name, stats)`` times one stretch of the program's host code.  While
a ``torch.profiler`` runs, it also opens the range ``repro_torch.<name>``
(``record_function``), which the profiler records on the same timeline as
the card's operations, so a trace names what the host was doing in each
gap of the device.  With no profiler running it never enters
``record_function``: the check is one module attribute, and a span then
costs two ``perf_counter`` calls.

Each run's numbers live on ``stats.trace``, a ``RunTrace`` that
``RunStats`` sets as a plain attribute (not a dataclass field, so
``dataclasses.asdict``, ``fields`` and ``==`` do not see it): host seconds
and calls by span name, the bytes and count of host-to-card uploads
(``core.engine.peel_loop.upload``), the bytes of the matrices built on the
card from uploaded edge ids (``built_bytes``), the largest support the
run's count read (``max_support``) and the bytes of the float64 buffers
it allocated for supports, tip numbers and B2 stacks (``wide_bytes``).

``recent_runs()`` is the operator's view of what recent runs did: the
``RunStats`` of the last ``RECENT_RUNS`` engine runs (``Executor``'s
decompose and repeel), oldest first.  It holds the objects themselves, so
what a caller adds to a run's stats afterwards shows there too::

    from repro_torch.utils.spans import recent_runs
    last = recent_runs()[-1]
    last.trace.seconds["read"], last.trace.upload_bytes
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List

import torch

__all__ = ["PREFIX", "RECENT_RUNS", "RunTrace", "span", "note_run",
           "recent_runs", "clear_recent_runs"]

PREFIX = "repro_torch."
RECENT_RUNS = 1024

# torch keeps ``_is_profiler_enabled`` for cheap checks like this one
_profiler = torch.autograd.profiler
_clock = time.perf_counter
_recent: Deque = collections.deque(maxlen=RECENT_RUNS)


@dataclasses.dataclass
class RunTrace:
    """One run's span table and upload counters; ``built_bytes`` the
    bytes of every matrix built on the card from edge ids
    (``core.engine.peel_loop.DeviceGraph``); ``max_support`` the largest
    support the run's count read, 0 where it read none
    (``peel_loop.check_exact``); ``wide_bytes`` the bytes of every float64
    buffer the run allocated on its device for supports and their peel
    deltas, tip numbers, bounds and B2 stacks, counted where each is made
    (``peel_loop.note_wide``; temporaries of elementwise steps are not)."""

    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    upload_bytes: int = 0
    uploads: int = 0
    built_bytes: int = 0
    max_support: float = 0.0
    wide_bytes: int = 0

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.calls[name] = self.calls.get(name, 0) + 1


class span:
    """``with span(name, stats):`` times the block into ``stats.trace``
    (when ``stats`` is given) and, under a running profiler, records it
    as the range ``repro_torch.<name>``."""

    __slots__ = ("name", "stats", "t0", "rf")

    def __init__(self, name: str, stats=None):
        self.name = name
        self.stats = stats
        self.rf = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        if self.stats is not None:
            self.stats.trace.add(self.name, _clock() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        return False


def note_run(stats) -> None:
    """Keep ``stats`` (the object itself) among the recent runs."""
    _recent.append(stats)


def recent_runs() -> List:
    """The ``RunStats`` of the last ``RECENT_RUNS`` engine runs, oldest
    first."""
    return list(_recent)


def clear_recent_runs() -> None:
    _recent.clear()
