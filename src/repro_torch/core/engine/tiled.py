"""Tiled-sparse whole-graph tip decomposition (port of
``repro.core.engine.tiled``, DESIGN.md section 9).

``receipt_tiled`` is the engine behind ``representation="tiled"``: the
whole-graph EXACT schedule — simultaneous level peel from the initial
per-vertex butterfly counts with ``lo = 0``, the ParButterfly schedule —
over the nonzero-tile list (``core.graph.TiledGraph`` +
``kernels.butterfly_tiled``), never materializing a ``(rows_pad,
cols_pad)`` matrix on the host or the card.  Tip numbers are canonical,
so this is the decomposition the dense CD + FD pipeline computes:

* a butterfly contains exactly two U vertices, so when a peel set S is
  removed, ``delta[x] = sum_{y in S, y != x} C(W[x, y], 2)`` charges each
  butterfly to exactly one peeled partner, with the adjacency held static
  during the sweep;
* ``W[x, y] = |N(x) & N(y)|`` depends only on rows x and y, so the
  regather between sweeps (zeroing peeled rows and columns whose residual
  degree dropped below 2, ``regather_tiles``) never changes an alive
  pair's wedge count.

The reference runs each segment of the peel as one ``lax.while_loop``.
Here ``_tiled_segment`` is a Python loop over device tensors with the same
body (``level_threshold`` / ``select_peel``, kernel 6, the masked column
sums and ``peel_cost``, ``record_theta`` / ``apply_delta`` with the clamp
at the running level, the residual degrees, the regather), and each sweep
makes ONE blocking read: the peel-set and alive sizes, fetched together.
The alive size is the loop test; the peel-set size steers the plain
kernel's path on the CPU, so no other read is needed.  The regather
rewrites the tile payload in place.

The host driver runs the loop in segments of ``cfg.tiled_compact_every``
sweeps (bounded by the ``cfg.max_sweeps`` valve) and fetches the segment's
state once at its end: it scatters the newly assigned theta and, once the
alive-row share drops to ``cfg.tiled_compact_ratio``, rebuilds the slot
list from the survivors on the host.  Supports are CARRIED across a
rebuild, never recounted: they are the loop's values clamped at the
running level, and a recount could fall below it.

Kernel 6 sums its supports in float32, so this route is exact below
``peel_loop.F32_EXACT_LIMIT`` = 2^24 only (DESIGN.md section 8): the
count's largest support rides each segment's fetch, and one at or past
the limit refuses the run (``peel_loop.check_exact``) before any tip
number is returned.

With a ``plan`` (``repro_torch.api.ExecutionPlan``) every slot-list build
records its padded rows and columns and its slot count through
``plan.quantize_dim`` (``tiled_rows``, ``tiled_cols``, ``tiled_slots``).
The reference pads these up to what an earlier same-signature run
compiled, and the slot count to a bucket of 8 even on a cold plan, so
that its jit cache hits; the port has no jit cache, so it builds exactly
the slots the graph has, plan or not.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from ...kernels import butterfly_tiled as ktiled
from ...kernels import ops as kops
from ..graph import BipartiteGraph, TiledGraph
from ...utils.spans import span
from .peel_loop import (
    F32_EXACT_LIMIT,
    ReceiptConfig,
    RunStats,
    apply_delta,
    bucket,
    check_exact,
    fetch,
    level_threshold,
    peel_cost,
    record_theta,
    select_peel,
)

__all__ = ["receipt_tiled", "tiled_blocks", "build_tiled"]

_F32 = torch.float32


def tiled_blocks(cfg: ReceiptConfig) -> Tuple[int, int]:
    """(block_rows, block_k) of the tiled layout: ``(max(bi, bj), bk)``.

    One rule for every port backend (the reference's non-``xla`` rule),
    so kernel 6 and its plain version see the same layout: the B side
    mirrors row bands of the same slot list, so the row block covers both
    the bi and the bj role of the dense kernels.
    """
    bi, bj, bk = (int(b) for b in cfg.kernel_blocks)
    return max(bi, bj), bk


def build_tiled(g: BipartiteGraph, cfg: ReceiptConfig,
                plan=None) -> TiledGraph:
    """The engine's ``TiledGraph`` of ``g``: rows and columns padded to
    power-of-two-ish buckets of the tile blocks, no filler slots; the
    sizes are recorded in ``plan`` when one is given (module docstring)."""
    br, bc = tiled_blocks(cfg)
    rows_pad = bucket(max(g.n_u, 1), br)
    cols_pad = bucket(max(g.n_v, 1), bc)
    if plan is not None:
        rows_pad = plan.quantize_dim("tiled_rows", rows_pad)
        cols_pad = plan.quantize_dim("tiled_cols", cols_pad)
    tg = TiledGraph.from_graph(g, block_rows=br, block_k=bc,
                               rows_pad=rows_pad, cols_pad=cols_pad)
    if plan is not None:
        plan.quantize_dim("tiled_slots", tg.n_slots)
    return tg


def _tiled_update(td, lists, sl, s, n_s, backend):
    """Kernel 6 on CUDA tensors, its plain version on CPU tensors, handed
    ``n_s``, the nonzero count of ``s`` the caller has already read, so
    that neither reads anything of its own to size its scratch or pick its
    path."""
    if td.device.type == "cuda":
        return kops.butterfly_update_tiled(td, *lists, sl, s, backend=backend,
                                           n_srows=n_s)
    return ktiled.butterfly_update_tiled_plain(td, *lists, sl, s, n_srows=n_s)


def _tiled_sweep(st: dict, lists: tuple, *, backend, regather,
                 stats) -> Tuple[dict, int, int]:
    """One sweep of the tiled level peel (the reference's loop body), with
    its one blocking read.  Returns (state, n_peel, n_alive): when no row
    is alive (``n_alive == 0``) nothing is applied."""
    srow, scol, _sptr, pos = lists
    sup, al = st["support"], st["alive"]
    # lo = 0 as a device fill: a host scalar would be a copy that waits
    hi, cap = level_threshold(sup, al, sup.new_zeros(()))
    peel = select_peel(sup, al, hi)
    n_peel, n_alive = (int(x) for x in fetch(stats, peel.sum(), al.sum()))
    if n_alive == 0:
        return st, n_peel, n_alive
    peelf = peel.to(_F32)
    td = st["td"]
    delta = _tiled_update(td, lists, st["sl"], peelf, n_peel, backend)
    # dynamic wedge charge of this peel set: the peeled rows' column sums
    # against the residual degrees (the peel_cost identity)
    csum = ktiled.masked_colsum_tiled(td, srow, scol, pos, peelf)
    wedges = st["wedges"] + peel_cost(csum, st["dv"])
    theta = record_theta(st["theta"], peel, cap)
    # Alg. 2 line 13: survivors cap at the CURRENT level, so the peel
    # level is monotone (a survivor outlived the cap-level peel)
    sup, al = apply_delta(sup, al, peel, delta, cap)
    dv = st["dv"] - csum
    sl = st["sl"]
    if regather:
        td, sl = ktiled.regather_tiles(td, srow, scol, al.to(_F32),
                                       (dv >= 2.0).to(_F32))
    return (dict(td=td, sl=sl, support=sup, alive=al, theta=theta, dv=dv,
                 wedges=wedges), n_peel, n_alive)


def _tiled_segment(st: dict, lists: tuple, *, backend, max_sweeps,
                   regather_every, stats) -> Tuple[dict, int]:
    """Up to ``max_sweeps`` sweeps (one reference ``_tiled_peel_loop``
    invocation); ends early when no row is alive.  ``wedges`` restarts at
    0 (f32, as the reference accumulates it within a segment).  Returns
    (state, sweeps)."""
    st = dict(st, wedges=torch.zeros((), dtype=_F32,
                                     device=st["support"].device))
    sweeps = 0
    while sweeps < max_sweeps:
        regather = sweeps % regather_every == regather_every - 1
        st, n_peel, n_alive = _tiled_sweep(
            st, lists, backend=backend, regather=regather, stats=stats)
        if n_alive == 0:
            break
        sweeps += 1
        if n_peel == n_alive:
            break                     # every survivor peeled: none is alive
    return st, sweeps


def receipt_tiled(
    g_work: BipartiteGraph,
    cfg: ReceiptConfig,
    stats: RunStats,
    *,
    device,
    plan=None,
) -> np.ndarray:
    """Whole-graph tiled tip decomposition of the U side of ``g_work``
    (``plan``: records the slot-list builds' sizes, module docstring).

    Returns theta float64[n_u] in ``g_work`` labels (``tip_decompose``
    handles the side transposition and the degree-sort unmapping, as for
    the dense CD + FD pipeline).
    """
    t0 = time.perf_counter()
    backend = kops.resolve_backend(cfg.backend, device)
    n_u = g_work.n_u
    stats.wedges_pvbcnt = g_work.counting_wedge_bound()
    stats.num_subsets = 1
    theta_out = np.zeros(n_u, np.float64)
    cur_ids = np.arange(n_u, dtype=np.int64)
    # host DGM pre-compaction: degree-<2 columns complete no wedge
    sub, _v_map = g_work.induced_on_u(cur_ids, min_degree_v=2)
    stats.dgm_compactions += 1
    seg_sweeps = max(1, min(cfg.max_sweeps, cfg.tiled_compact_every))
    support_carry = None             # None until the first count
    stats.time_count += time.perf_counter() - t0

    def up(x):
        return torch.from_numpy(x).to(device)

    t1 = time.perf_counter()
    while True:
        # (re)build the slot list of the current survivor graph; the peel
        # state carries over (supports carried, never recounted)
        tg = build_tiled(sub, cfg, plan=plan)
        td = up(tg.tile_data)
        lists = (up(tg.srow), up(tg.scol), up(tg.sptr), up(tg.pos))
        rows_pad, n_cur = tg.rows_pad, sub.n_u
        alive = torch.arange(rows_pad, device=device) < n_cur
        sl = ktiled.slot_liveness(td)
        if support_carry is None:
            tc = time.perf_counter()
            with span("count", stats):
                support = _tiled_update(td, lists, sl, alive.to(_F32), n_cur,
                                        backend)
                top = torch.where(alive, support, 0.0).amax()
            stats.time_count += time.perf_counter() - tc
        else:
            sup_host = np.zeros(rows_pad, np.float32)
            sup_host[:n_cur] = support_carry
            support = up(sup_host)
        st = dict(td=td, sl=sl, support=support, alive=alive,
                  theta=torch.zeros(rows_pad, dtype=_F32, device=device),
                  dv=ktiled.colsum_tiled(td, lists[1], tg.n_col_tiles))
        prev_alive = np.ones(n_cur, dtype=bool)

        done = False
        while True:
            st, n_sweeps = _tiled_segment(
                st, lists, backend=backend, max_sweeps=seg_sweeps,
                regather_every=cfg.tiled_regather_every, stats=stats)
            stats.device_loop_calls += 1
            # the count's largest rides every segment's read
            wed, alive_h, theta_h, sup_h, top_h = fetch(
                stats, st["wedges"], st["alive"], st["theta"],
                st["support"], top)
            check_exact(stats, float(top_h), F32_EXACT_LIMIT,
                        backend=backend, representation="tiled")
            stats.rho_fd += n_sweeps
            stats.wedges_fd += int(round(float(wed)))
            stats.dgm_device_compactions += (
                n_sweeps // cfg.tiled_regather_every)
            alive_h = alive_h[:n_cur].astype(bool)
            died = prev_alive & ~alive_h
            theta_out[cur_ids[died]] = theta_h[:n_cur][died]
            prev_alive = alive_h
            n_alive = int(alive_h.sum())
            if n_alive == 0:
                done = True
                break
            if (cfg.tiled_compact_ratio > 0.0
                    and n_alive <= cfg.tiled_compact_ratio * n_cur):
                # host recompaction: rebuild the slot list from the
                # survivors, so each sweep's cost tracks the residual graph
                keep = np.where(alive_h)[0]
                support_carry = sup_h[:n_cur][keep].astype(np.float32)
                cur_ids = cur_ids[keep]
                sub, _v_map = sub.induced_on_u(keep, min_degree_v=2)
                stats.dgm_compactions += 1
                # the old tile list goes before the new one is uploaded:
                # the card never holds two
                st = td = lists = sl = support = alive = None
                break
        if done:
            break
    stats.sweeps_per_subset.append(stats.rho_fd)
    stats.subset_sizes.append(n_u)
    stats.time_fd += time.perf_counter() - t1
    return theta_out
