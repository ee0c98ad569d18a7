"""RECEIPT — facade over `core/engine/` (port of ``repro.core.receipt``).

``tip_decompose`` keeps the engine's signature and routes through the API
layer (``repro_torch.api.decompose``: plan, then execute on a fresh
Executor, which reuses nothing across calls), so it is bit-identical to
the engine.  ``parb_tip_decompose``, ``receipt_cd`` and ``receipt_fd``
stay phase-level entry points.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .engine import (
    DeviceGraph,
    ReceiptConfig,
    RunStats,
    batched_level_loop,
    bucket,
    cd_checkpoint_state,
    cd_graph_state0,
    device_cd_graph_loop,
    device_peel_loop,
    find_hi_np,
    host_sweep,
    parb_tip_decompose,
    receipt_cd,
    receipt_fd,
)
from .graph import BipartiteGraph

__all__ = [
    "ReceiptConfig",
    "RunStats",
    "tip_decompose",
    "receipt_cd",
    "receipt_fd",
    "parb_tip_decompose",
    "cd_checkpoint_state",
    "DeviceGraph",
    "device_peel_loop",
    "device_cd_graph_loop",
    "cd_graph_state0",
    "batched_level_loop",
    "host_sweep",
    "bucket",
    "find_hi_np",
]


def tip_decompose(
    g: BipartiteGraph, cfg: Optional[ReceiptConfig] = None,
    *, side: str = "U", device=None,
) -> Tuple[np.ndarray, RunStats]:
    """Full RECEIPT tip decomposition through ``repro_torch.api``
    (planning included); see ``repro_torch.core.engine.tip_decompose`` for
    the knobs.  Returns (theta int64[n_side], RunStats)."""
    from .. import api

    td = api.decompose(g, cfg, side=side, device=device)
    return td.theta, td.stats
