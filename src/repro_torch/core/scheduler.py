"""Workload-aware scheduling for FD subsets (paper section 3.2.1).

The port's copies of ``repro.core.scheduler.pack_by_shape`` and
``lpt_assign``: subsets are grouped by their bucketed padded shape, so each
batched stack wastes minimal padding, and sorted by wedge count descending
(LPT order) inside a group; ``lpt_assign`` splits a group into balanced
chunks (``Executor.map``).  ``lpt_shard_plan`` arrives with the
distributed slice.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["pack_by_shape", "lpt_assign"]


def pack_by_shape(
    tasks: Sequence,
    *,
    size_of: Callable,
    weight_of: Callable,
    bucket: Callable[[int], int],
    bucket_cols: Optional[Callable[[int], int]] = None,
) -> List[List]:
    """Group tasks by bucketed padded shape; LPT order inside each group.

    size_of(task) -> (rows, cols); weight_of(task) -> workload proxy
    (wedge count); bucket(n) -> padded size (rows; also cols unless
    ``bucket_cols`` overrides it — kernel row/contraction tiles usually
    differ).  Returns a list of groups (each a list of tasks), heaviest
    groups first.
    """
    bucket_cols = bucket_cols or bucket
    groups: Dict[Tuple[int, int], List] = {}
    for t in tasks:
        r, c = size_of(t)
        key = (bucket(max(r, 1)), bucket_cols(max(c, 1)))
        groups.setdefault(key, []).append(t)
    out = []
    for key in sorted(groups, key=lambda k: -(k[0] * k[1])):
        grp = sorted(groups[key], key=weight_of, reverse=True)
        out.append(grp)
    return out


def lpt_assign(weights: Sequence[float], k: int,
               init_loads: Optional[Sequence[float]] = None,
               ) -> List[List[int]]:
    """Longest-Processing-Time assignment of tasks to ``k`` workers.

    Returns per-worker lists of task indices.  Graham's classic
    4/3-approximation [Graham 1969], the rule the paper's workload-aware
    scheduling is modeled on (Fig. 3).  ``init_loads`` seeds the
    per-worker loads (list scheduling on pre-loaded machines).
    """
    order = sorted(range(len(weights)), key=lambda i: -weights[i])
    loads = (list(init_loads) if init_loads is not None else [0.0] * k)
    if len(loads) != k:
        raise ValueError(f"init_loads has {len(loads)} entries for {k} "
                         "workers")
    assign: List[List[int]] = [[] for _ in range(k)]
    for i in order:
        j = loads.index(min(loads))
        assign[j].append(i)
        loads[j] += weights[i]
    return assign
