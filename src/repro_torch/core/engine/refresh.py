"""Incremental refresh (port of ``repro.core.engine.refresh``), in part.

Only ``synthesize_bounds`` is here: ``Executor.map`` gives each mapped
result a CD-style bound ladder.  The prefix re-peel loops
(``repeel_tip_prefix`` / ``repeel_wing_prefix``) arrive with the refresh
slice (ROADMAP.md, queue 1, item 4).
"""
from __future__ import annotations

import numpy as np

__all__ = ["synthesize_bounds"]


def synthesize_bounds(numbers, num_partitions: int):
    """Coarse ascending CD-style bound ladder from COMPUTED peel numbers.

    ``Executor.map`` runs the whole-graph level schedule (``lo = 0``) and
    never builds Alg. 3's theta-range partition; the exact numbers in hand
    quantize into ``num_partitions`` equi-mass rungs, a valid stop ladder:
    strictly increasing, integral rungs, ``bounds[0] == 0`` and
    ``bounds[-1] > numbers.max()`` (the invariants
    ``verify_tip_decomposition`` checks).
    """
    th = np.asarray(numbers, np.float64).reshape(-1)
    t_max = float(th.max()) if th.size else 0.0
    interior = np.empty(0, np.float64)
    if th.size and int(num_partitions) > 1:
        qs = np.linspace(0.0, 1.0, int(num_partitions) + 1)[1:-1]
        interior = np.round(np.quantile(th, qs))
    rungs = np.unique(np.concatenate(
        [[0.0], interior, [t_max + 1.0]]))
    return [float(b) for b in rungs]
