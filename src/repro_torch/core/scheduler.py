"""Workload-aware scheduling for FD subsets (paper section 3.2.1).

The port's copies of ``repro.core.scheduler.pack_by_shape``,
``lpt_assign`` and ``lpt_shard_plan``: subsets are grouped by their
bucketed padded shape, so each batched stack wastes minimal padding, and
sorted by wedge count descending (LPT order) inside a group;
``lpt_assign`` splits a group into balanced chunks (``Executor.map``), and
``lpt_shard_plan`` lays that assignment out as equal-size contiguous
shards of a stack (the mesh FD, ``core/distributed.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["pack_by_shape", "lpt_assign", "lpt_shard_plan"]


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


def lpt_shard_plan(weights: Sequence[float], k: int,
                   init_loads: Optional[Sequence[float]] = None,
                   ) -> Tuple[List[int], int]:
    """LPT assignment flattened into a shardable layout.

    Returns (slots, per_shard): ``slots`` is a length ``k * per_shard``
    list where slot ``s * per_shard + j`` holds the task index placed at
    position j of shard s, or -1 for a padding slot.  Reordering a task
    stack by this plan makes contiguous equal-size shards LPT-balanced.
    ``init_loads`` passes through to ``lpt_assign`` (load carried across
    shape groups).
    """
    assign = lpt_assign(weights, k, init_loads)
    per_shard = max(max((len(a) for a in assign), default=0), 1)
    slots: List[int] = []
    for a in assign:
        slots.extend(a)
        slots.extend([-1] * (per_shard - len(a)))
    return slots, per_shard
