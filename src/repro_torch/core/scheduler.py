"""Workload-aware scheduling for FD subsets (paper section 3.2.1).

The port's copy of ``repro.core.scheduler.pack_by_shape``: subsets are
grouped by their bucketed padded shape, so each batched stack wastes
minimal padding, and sorted by wedge count descending (LPT order) inside a
group.  ``lpt_assign`` / ``lpt_shard_plan`` arrive with the distributed
slice.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["pack_by_shape"]


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
