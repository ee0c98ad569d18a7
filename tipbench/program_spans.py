"""The program's own spans and counters, for the per-layer readers that
read them: the runs of ``repro_torch.utils.spans.recent_runs()`` that are
the traced window's requests.

A window record keeps four numbers of its request's ``RunStats``
(``loops._stats``): ``host_round_trips``, ``time_count``, ``time_cd`` and
``time_fd``, copied as they are.  The window's runs are the latest
contiguous stretch of the recent runs whose four numbers equal the
records', in order.  Each run carries its span seconds by name and its
upload bytes on ``stats.trace``.  A program without the module, or whose
recent runs do not hold the window (cleared, or overrun), gives None, and
the metric is left out of the result line.
"""
from __future__ import annotations

from typing import Callable, List, Optional

__all__ = ["window_runs", "mean", "seconds"]

# (record key, RunStats attribute, type)
KEYS = (("round_trips", "host_round_trips", int),
        ("time_count", "time_count", float),
        ("time_cd", "time_cd", float),
        ("time_fd", "time_fd", float))


def window_runs(run) -> Optional[List]:
    """The ``RunStats`` of the window's requests, in order, or None."""
    try:
        from repro_torch.utils.spans import recent_runs
    except ImportError:
        return None
    want = [tuple(kind(r[key]) for key, _, kind in KEYS)
            for r in run.get("records", []) if "round_trips" in r]
    if not want:
        return None
    runs = recent_runs()
    have = [tuple(kind(getattr(s, attr)) for _, attr, kind in KEYS)
            for s in runs]
    n = len(want)
    for i in range(len(have) - n, -1, -1):
        if have[i: i + n] == want:
            return runs[i: i + n]
    return None


def mean(run, value: Callable) -> Optional[float]:
    """The mean of ``value(trace)`` over the window's runs, or None."""
    runs = window_runs(run)
    if not runs:
        return None
    return sum(value(s.trace) for s in runs) / len(runs)


def seconds(name: str) -> Callable:
    """A run's host seconds in the span ``name`` (0 where it never ran)."""
    return lambda trace: trace.seconds.get(name, 0.0)
