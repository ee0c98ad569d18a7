"""RECEIPT — facade over `core/engine/` (port of ``repro.core.receipt``).

``tip_decompose`` calls the engine directly until the API layer
(``api/config.py``, ``plan.py``, ``executor.py``) is ported; the
reference's facade is pinned bit-identical to its engine
(tests/test_api_compat.py), so nothing is lost.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import engine
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
    """Full RECEIPT tip decomposition; see
    ``repro_torch.core.engine.tip_decompose``."""
    return engine.tip_decompose(g, cfg, side=side, device=device)
