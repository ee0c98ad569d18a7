"""Baselines on the peel core (port of ``repro.core.engine.baselines``).

ParButterfly-style batch peeling shares the engine with RECEIPT: the same
kernels and the same sweep loop (`engine/peel_loop`), only the schedule
differs — **min-peel** (``device_peel_loop(minmode=True)``) instead of
CD's range peel.  The one independent variable left is the number of
synchronization rounds, which is the paper's argument.

The port's loops size each gather to its peel set, so the reference's
peel-buffer overflow and its host replay (``host_sweep`` after an
overflow) have no counterpart: ``RunStats.overflow_fallbacks`` stays 0.

The device theta takes the supports' dtype (float64), so ParB is exact
below ``peel_loop.EXACT_LIMIT`` = 2^53 as RECEIPT is: the count's largest
support rides each loop's fetch (``check_exact``).
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ...kernels import ops as kops
from ..graph import BipartiteGraph
from .peel_loop import (
    _INF,
    EXACT_LIMIT,
    SUPPORT_DTYPE,
    DeviceGraph,
    ReceiptConfig,
    RunStats,
    check_exact,
    device_peel_loop,
    fetch,
    host_sweep,
    resolve_device,
    support_all,
)

__all__ = ["parb_tip_decompose"]


def parb_tip_decompose(
    g: BipartiteGraph, cfg: Optional[ReceiptConfig] = None, *, device=None,
) -> Tuple[np.ndarray, RunStats]:
    """ParButterfly-style batch peeling on the dense engine.

    The same kernels and loop machinery as RECEIPT, but each sweep peels
    only the CURRENT MINIMUM support set (the ParB schedule); theta is the
    sweep's level, recorded on the device, with terminal-sweep elision.
    ``cfg.device_loop=False`` keeps the reference's blocking host schedule
    (two reads per sweep, then ``host_sweep``).  ``device=None`` runs on
    the card.

    Returns (theta int64[n_u], RunStats).
    """
    cfg = cfg or ReceiptConfig()
    dev = resolve_device(device)
    stats = RunStats()
    backend = kops.resolve_backend(cfg.backend, dev)
    blocks = cfg.kernel_blocks
    sparse = backend in kops.SPARSE_BACKENDS

    dg = DeviceGraph(g, np.arange(g.n_u), cfg, device=dev)
    stats.wedges_pvbcnt = g.counting_wedge_bound()
    alive = torch.arange(dg.rows_pad, device=dev) < dg.n_rows
    support = support_all(dg.a, alive, dg.ids, dg.kmax if sparse else None,
                          backend=backend, blocks=blocks, stats=stats)
    # the largest count, read with every loop's fetch
    top = torch.where(alive, support, 0.0).amax()
    support = torch.where(alive, support, _INF)

    theta = np.zeros(g.n_u, np.int64)
    t0 = time.perf_counter()
    if cfg.device_loop:
        dv = dg.dv0
        theta_dev = torch.zeros(dg.rows_pad, dtype=SUPPORT_DTYPE, device=dev)
        while True:
            (support, alive, dv, theta_dev, peeled, d_rho, d_wedges, _h,
             d_elided, _c, _s, _ovf) = device_peel_loop(
                dg.a, dg.ids, support, alive, dv, theta_dev, 0.0, 0.0, 0.0,
                backend=backend, blocks=blocks, use_huc=False,
                max_sweeps=cfg.max_sweeps, minmode=True, row_ext=dg.row_ext,
                kmax=dg.kmax, stats=stats)
            stats.device_loop_calls += 1
            peeled_np, alive_np, th_np, wedges_np, top_h = fetch(
                stats, peeled, alive, theta_dev, d_wedges, top)
            check_exact(stats, float(top_h), EXACT_LIMIT, backend=backend)
            stats.rho_cd += d_rho
            stats.wedges_cd += int(wedges_np)
            stats.elided_sweeps += d_elided
            sel = peeled_np[: dg.n_rows].nonzero()[0]
            theta[dg.members[sel]] = np.round(
                th_np[: dg.n_rows][sel]).astype(np.int64)
            # a max_sweeps cap-exit with survivors left re-enters; no sweep
            # at all means no progress is possible
            if not alive_np.any() or d_rho == 0:
                break
    else:
        while True:
            n_alive, mn, top_h = fetch(
                stats, alive.sum(), torch.where(alive, support, _INF).amin(),
                top)
            check_exact(stats, float(top_h), EXACT_LIMIT, backend=backend)
            if int(n_alive) == 0:
                break
            mn = float(mn)
            support, alive, info = host_sweep(
                dg, cfg, stats, support, alive, mn + 1.0, mn, backend,
                blocks, allow_huc=False)
            if info is None:
                break
            sel = info["peel_np"][: dg.n_rows].nonzero()[0]
            theta[dg.members[sel]] = int(mn)
    stats.time_cd = time.perf_counter() - t0
    return theta, stats
