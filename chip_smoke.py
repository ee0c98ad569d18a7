#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # needs one CUDA card; 4 to 8 minutes

Phases (any failure exits nonzero; no phase is caught and ignored):

1. card: name, and name + power limit as ``nvidia-smi`` reports them;
2. build: every kernel of the main paths, from ``src/repro_torch/kernels/
   csrc``, one ``nvcc`` per source, all at once;
3. kernel vs plain, on the card, at the shapes the full-size runs give
   them: ``torch.equal`` to the plain PyTorch version (the f32 integer
   regime makes them bit-identical; the staircase kernels get their real
   extents, the tiled kernel the tiled path's own slot list), then each
   one's time (CUDA events, warmed, over many launches), its bound
   (operations and bytes over the live stripes only, for the
   stripe-skipping forms, whose skipped share is printed; over each pair
   of distinct rows with s mass once, for the symmetric count forms of
   kernels 1 and 4; over the live columns of the rows with mass for the
   peel forms of kernels 1, 4 and 6; the earlier bound printed beside
   each redesigned form's), the plain version's time and the time of the
   bare matrix product (product only, not the same function; for the
   count forms also the int8 product of the s8 copy, ``torch._int_mm``).
   The redesigned bodies are also held and timed against the body they
   replaced, on the same operands: kernels 1 and 4 against their f32 tile
   body at the counting form and at a 256-row CD update, kernel 1 also
   at ParB's own shape (its unsorted matrix, 128 gathered rows, one
   valid); kernels 2, 3 and 5 against their f32 tile bodies at FD's
   (16, 1024, 1024) stack (bounds per group over the live columns of
   the valid rows for 2 and 5, over the distinct nonzero row pairs for
   3), then held on ragged (3, 777, 1000) stacks, kernel 3 also at
   bi != bj; kernel 6 against its count body at every alive row (its
   count launch, which takes the peel body too) and at 1, 16, 64 and 256
   peeled rows; kernels 2 and 5 also at ``Executor.map``'s counting
   form, the map fleet's own (128, 1024, 512) stack with A = B and every
   row alive (bound: 2 G m^2 n_v int8 operations or one read of the
   stack, the larger), and kernel 3 at ``map``'s b2 form on that stack
   (bound over its distinct nonzero row pairs, or the stack read and the
   (128, 1024, 1024) output written once).  Times are device time per
   call (a CUDA graph of many calls, replayed between CUDA events); the new
   bodies' eager time, host enqueue included, and their launches' device
   times (profiler) are printed beside;
   then the times of the tiled path's tile-list passes (the in-place
   regather, the liveness, the column sums);
4. small end to end: three graphs, both sides, backends "cuda" and
   "cuda_sparse", both ``cd_dispatch`` values, ``fd_update_mode`` "b2" and
   "kernel", and the tiled representation, ``fd_mode`` "b2" and "matvec"
   and the ParB baseline, theta equal to ``bup_oracle``;
5. full size: four paths on
   ``powerlaw_bipartite(6486, 12942, 96662, seed=0)`` (the published shape
   of KONECT's Marvel character-comic network), side U: ``tip_decompose``
   with P = 150 (the paper's section 5.1 setting) on the dense backend and
   the subset dispatch (``ReceiptConfig(num_partitions=150)``), on the
   staircase backend and the whole-graph dispatch (``backend=
   "cuda_sparse", cd_dispatch="graph"``) and on the tiled representation
   (``representation="tiled"``), then ``parb_tip_decompose`` (the ParB
   baseline).  Launch counts are set to 0 just before each path and read
   just after it.  Theta must equal one exact oracle (Alg. 2 on a scipy
   float64 B2) on every path, the tiled path's sweeps must equal ParB's
   rounds, every kernel must have launched on at least one path, and
   each path's count and peel bodies on it, and its stack bodies of
   kernels 2, 3 and 5 (launches are counted per body), and no path may
   launch an f32 tile body; the (G, m, n_v) of every call of kernels 2,
   3 and 5 is logged; then each path twice more, under
   ``torch.profiler`` (device time by kernel, busy share of the wall, and
   the device time of each call of kernels 2, 3 and 5) and ``cProfile``
   (host time by function);
5b. the API layer (``repro_torch.api``, the port's entry point), each
   path with the launch counts set to 0 just before and read just after:
   ``Executor(EngineConfig(num_partitions=150, backend="cuda_sparse",
   cd_dispatch="graph"))`` on the full-size graph, cold, then a cache
   hit on a vertex-permuted copy, with the plan's ``describe()``, its
   planning time, ``cache_stats``, host round trips and
   ``plan.padded_bytes`` beside ``max_memory_allocated``; the config's
   ``representation="auto"`` must pick dense; a memory budget between
   the tile list's estimate and the dense matrix's bytes (64-wide tiles)
   must route it tiled through kernel 6; ``Executor.map`` on a synthetic
   fleet of 128 power-law graphs ``powerlaw_bipartite(1024, 512, 8192,
   seed=100 + k)``, sized to fill one chunk of the default
   ``map_stack_cells`` (one (1024, 512) bucket, one chunk) on ``"cuda"``,
   ``"cuda_sparse"`` and ``"cuda_sparse"`` with ``fd_update_mode="b2"``,
   then a warm fleet (``seed=500 + k``) whose cache hit rate (chunk
   shapes seen before: kept for parity, nothing is reused) must be 1.0,
   every member
   equal to the exact oracle and members 0-3 to their own
   ``Executor.decompose``; ``verify=True`` on phase 4's graphs and
   sp_mid; phase 5's paths now run through the facade's Executor, and
   their planning time, timed apart, is logged beside their walls;
6. crossover: tile occupancy at the card's 128 x 512 tiles and the warm
   wall (second run) of the staircase + graph path against the tiled path
   on the sp_mid and sp_large graphs of the reference's benchmark ladder
   and on the full-size graph, both exact; recorded only, nothing routes
   by it;
7. the kernel list as one JSON line, then the result line.

It imports nothing of ``repro`` (the JAX package) or ``jax``.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
INT8_OPS_PER_S = 1979e12     # 0/1 operands, counts < 2^24: exact in int8
HBM_BYTES_PER_S = 3.35e12
EXACT_LIMIT = 2 ** 24        # f32 integer regime (DESIGN.md section 8)

FULL = dict(n_u=6486, n_v=12942, m=96662, seed=0, partitions=150)
# Executor.map's fleet: MAP_GROUPS synthetic power-law graphs of this
# shape (seeds 100 + k cold, 500 + k warm), sized so that the fleet fills
# one chunk of the default map_stack_cells: one (1024, 512) bucket
MAP_FLEET = (1024, 512, 8192)
MAP_GROUPS = 128
# the forced tiled route: 64-wide tiles, where the full-size graph's tile
# list (its Planner estimate) fits below its dense matrix
TILED_ADMISSION_BLOCKS = (64, 64, 64)


def log(*args):
    print(*args, flush=True)


@functools.cache
def side_stream(torch):
    """The one stream every timing graph is warmed up and captured on:
    cuBLAS keeps a workspace for each stream it meets, allocated through
    PyTorch's allocator and never released, so a new stream per capture
    would leave one more workspace allocated each time."""
    return torch.cuda.Stream()


def time_ms(torch, fn, reps: int, eager: bool = False) -> float:
    """Mean device time of ``fn`` per call: ``reps`` calls captured in one
    CUDA graph and replayed between CUDA events, after warm-up calls, so
    the host's enqueue of each call (ctypes, allocations, several
    launches) is not in it.  ``eager``: the calls launched one by one
    between the events instead, which includes the enqueue wherever the
    host is slower than the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if eager:
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps
    side = side_stream(torch)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    gc.collect()             # the graph's memory pool goes with it
    return start.elapsed_time(stop) / reps


def kernel_device_ms(torch, fn, calls: int = 5) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, by
    kernel name, from ``torch.profiler`` over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type == DeviceType.CUDA and us > 0:
            hit = re.search(r"\w+_kernel\w*", e.key)
            name = hit.group(0) if hit else e.key[:40]
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out


def bound(ops: float, nbytes: float):
    """Least time (ms) the card needs for ``ops`` int8 tensor-core
    operations and ``nbytes`` of HBM traffic, and which one binds."""
    t_ops = ops / INT8_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def peel_live_work(torch, a, b, s, kmax_a=None, kmax_b=None, blocks=None):
    """Operations and bytes the gathered peel form of kernels 1 and 4
    needs, whatever implements it: W[i, j] is needed only for gathered
    rows j with s[j] != 0 ("valid"), and only over the live columns, where
    some valid row holds a nonzero (a column outside them adds 0 to every
    W that s does not zero).  With extents, column c of the pair (i, j)
    counts only below min(kmax_a[i / bi], kmax_b[j / bj]) * bk, as the
    Pallas grid skips stripes.  Operations: 2 per (A row, valid row, live
    column below the pair's bound); bytes: A's live columns below the
    farthest bound of each A row tile, read once in f32, the valid rows
    of B once (a row with s = 0 is never needed), s, the valid rows' ids,
    A's ids and out (and the extents).  Returns (operations, bytes, live
    columns)."""
    n_a, n_v = a.shape
    n_b = b.shape[0]
    valid = s != 0
    vrows = torch.nonzero(valid).squeeze(1)
    live = (b[vrows] != 0).any(dim=0)
    cum = torch.zeros(n_v + 1, dtype=torch.float64, device=a.device)
    cum[1:] = torch.cumsum(live.double(), dim=0)
    n_live = float(cum[-1])
    if kmax_a is None:
        ops = 2.0 * n_a * len(vrows) * n_live
        a_cols = n_a * n_live
        ext_bytes = 0.0
    else:
        bi, bj, bk = blocks
        lim = (torch.minimum(kmax_a.long()[:, None],
                             kmax_b.long()[vrows // bj][None, :]) * bk
               ).clamp(max=n_v)                      # (A row tiles, valid)
        tiles = torch.arange(kmax_a.numel(), device=a.device)
        rows = (n_a - tiles * bi).clamp(max=bi).double()
        ops = 2.0 * float((rows[:, None] * cum[lim]).sum())
        reach = (lim.amax(dim=1) if len(vrows)
                 else torch.zeros_like(tiles))
        a_cols = float((rows * cum[reach]).sum())
        ext_bytes = 4.0 * (kmax_a.numel() + kmax_b.numel())
    n_valid = len(vrows)
    nbytes = (4.0 * (a_cols + n_valid * n_v + n_b + n_valid + 2 * n_a)
              + ext_bytes)
    return ops, nbytes, n_live


def count_pair_ops(torch, a, s, kmax=None, blocks=None):
    """Operations the counting form of kernels 1 and 4 (B = A) needs,
    whatever implements it: W = A A^T is symmetric, so each pair {i, j}
    of distinct rows is needed once, and only when both rows hold a
    nonzero (an all-zero row has W = 0 with every row) and s[i] or s[j]
    is nonzero (a pair of rows without mass adds to neither out); 2
    operations per live column of the pair, the columns where some row
    with mass holds a nonzero (a pair with mass on j meets only j's
    columns), over every column, or with the shared extents (square
    tiles) only below min(kmax[i / bi], kmax[j / bi]) * bk.  Summed per
    (row tile, row tile) pair: the ordered pairs of nonzero rows with
    mass on a side, less the self-pairs on the diagonal, times the
    pair's live columns."""
    n, n_v = a.shape
    held = a != 0
    full = held.any(dim=1)                       # rows holding a nonzero
    mass = full & (s != 0)
    live = held[mass].any(dim=0)
    cum = torch.zeros(n_v + 1, dtype=torch.float64, device=a.device)
    cum[1:] = torch.cumsum(live.double(), dim=0)
    if kmax is None:
        bi = max(n, 1)
        cols = torch.full((1,), n_v, dtype=torch.long, device=a.device)
    else:
        bi, _, bk = blocks
        cols = (kmax.long() * bk).clamp(max=n_v)
    n_t = -(-n // bi)

    def per_tile(v):
        v = torch.nn.functional.pad(v.double(), (0, n_t * bi - n))
        return v.reshape(n_t, bi).sum(dim=1)

    rows, heavy = per_tile(full), per_tile(mass)
    idle = rows - heavy
    pairs = rows[:, None] * rows[None, :] - idle[:, None] * idle[None, :]
    pairs.diagonal().sub_(heavy)              # (i, i) with s[i] != 0
    lim = cum[torch.minimum(cols[:, None], cols[None, :])]
    return float((pairs * lim).sum())


def stack_peel_live_work(torch, a, b, s, kmax_a=None, kmax_b=None,
                         blocks=None):
    """Operations and bytes the stack form of kernels 2 and 5 needs,
    whatever implements it: each group g is an independent gathered peel
    update, so the stack needs the sum over the groups of what
    ``peel_live_work`` counts for (a[g], b[g], s[g]) and, with extents,
    the group's own (kmax_a[g], kmax_b[g]).  Returns (operations,
    bytes)."""
    ops = nbytes = 0.0
    for g in range(a.shape[0]):
        ext = () if kmax_a is None else (kmax_a[g], kmax_b[g], blocks)
        o, n, _ = peel_live_work(torch, a[g], b[g], s[g], *ext)
        ops += o
        nbytes += n
    return ops, nbytes


def b2_pair_ops(torch, a, kmax_a=None, kmax_b=None, blocks=None):
    """Operations kernel 3 needs, whatever implements it: out[g] =
    C(W_g, 2) with W_g = A_g A_g^T symmetric, so each pair {x, y} of
    distinct rows of a group is needed once, and only when both rows hold
    a nonzero (an all-zero row has W = 0 with every row); 2 operations
    per live column of the pair: a column some row of the group holds a
    nonzero in, below min(lim_x, lim_y), where lim_x is row x's tighter
    extent min(kmax_a[x / bi], kmax_b[x / bj]) * bk (both are upper
    bounds; every column without extents)."""
    g_n, m, n_v = a.shape
    held = a != 0
    full = held.any(dim=2)                                 # (G, m)
    cum = torch.zeros((g_n, n_v + 1), dtype=torch.float64, device=a.device)
    cum[:, 1:] = torch.cumsum(held.any(dim=1).double(), dim=1)
    if kmax_a is None:
        lim = torch.full((g_n, m), n_v, dtype=torch.long, device=a.device)
    else:
        bi, bj, bk = blocks
        per_a = kmax_a.long().repeat_interleave(bi, dim=1)[:, :m]
        per_b = kmax_b.long().repeat_interleave(bj, dim=1)[:, :m]
        lim = (torch.minimum(per_a, per_b) * bk).clamp(max=n_v)
    ops = 0.0
    upper = torch.ones(m, m, dtype=torch.bool, device=a.device).triu(1)
    for g in range(g_n):
        pair = torch.minimum(lim[g][:, None], lim[g][None, :])
        need = upper & full[g][:, None] & full[g][None, :]
        ops += 2.0 * float(cum[g][pair][need].sum())
    return ops


def tiled_peel_live_work(torch, td, scol, pos, live, s):
    """Operations and bytes kernel 6's mask form needs for a peel mask s,
    counted per column: row y with s mass meets the other rows only in
    its own live partner tiles pos[band(y), c], and there only at the
    columns where y holds a nonzero; each such column costs 2 bi
    operations for every live slot of column band c.  Bytes: those
    columns of the live slots of each column band (the columns where any
    row with mass holds a nonzero), read once in f32, s, out and the
    index arrays.  Returns (operations, bytes)."""
    n_slots, bi, bk = td.shape
    n_rt, n_ct = pos.shape
    ys = torch.nonzero(s).squeeze(1)
    p = pos.long()[ys // bi]                              # (n_y, n_ct)
    ok = (p >= 0) & (live[p.clamp(min=0)] != 0)
    nz = (td[p.clamp(min=0), (ys % bi)[:, None]] != 0) & ok[:, :, None]
    col_live = torch.zeros(n_ct, dtype=torch.float64, device=td.device)
    col_live.index_add_(0, scol.long(), (live != 0).double())
    ops = 2.0 * bi * float((nz.sum(dim=2).double() * col_live).sum())
    cols = nz.any(dim=0).sum(dim=1).double()                # (n_ct,)
    nbytes = (4.0 * bi * float((cols * col_live).sum()) + 4.0 * 2 * n_rt * bi
              + 4.0 * (3 * n_slots + n_rt + 1 + n_rt * n_ct))
    return ops, nbytes


def exact_theta(g):
    """Alg. 2 (sequential bottom-up peeling, as ``peeling.bup_oracle``)
    on B2 = C(A A^T, 2) from a scipy sparse float64 product (exact below
    2^53).  Returns (theta int64, max butterfly support)."""
    import numpy as np
    import scipy.sparse as sp

    a = sp.csr_matrix((np.ones(g.m), (g.edges_u, g.edges_v)),
                      shape=(g.n_u, g.n_v), dtype=np.float64)
    w = np.rint((a @ a.T).toarray()).astype(np.int64)
    b2 = w * (w - 1) // 2
    np.fill_diagonal(b2, 0)
    support = b2.sum(axis=1)
    max_support = int(support.max(initial=0))
    theta = np.zeros(g.n_u, np.int64)
    alive = np.ones(g.n_u, bool)
    for _ in range(g.n_u):
        cand = np.where(alive)[0]
        u = cand[np.argmin(support[cand])]
        th = support[u]
        theta[u] = th
        alive[u] = False
        upd = (b2[u] > 0) & alive
        support[upd] = np.maximum(th, support[upd] - b2[u][upd])
    return theta, max_support


def vhub_graph(BipartiteGraph, n_u=300, n_v=60, n_hubs=6, seed=6):
    """TrU-like regime: V-side hubs, light U side (HUC fires)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    eu, ev = [], []
    for u in range(n_u):
        hubs = rng.choice(n_hubs, size=rng.integers(1, 3), replace=False)
        light = n_hubs + rng.choice(
            n_v - n_hubs, size=rng.integers(1, 4), replace=False)
        cols = list(hubs) + list(light)
        eu += [u] * len(cols)
        ev += list(cols)
    return BipartiteGraph.from_edges(n_u, n_v, eu, ev)


def map_stack(np, fleet):
    """The (G, 1024, 512) stack ``Executor.map`` builds for ``fleet``:
    each graph degree-sorted, its degree-<2 columns dropped, scattered
    into its slice (as ``Executor._map_task`` / ``_map_chunk``)."""
    import torch

    a = np.zeros((len(fleet), 1024, 512), np.float32)
    for k, g in enumerate(fleet):
        sub = g.relabel_by_degree().induced_on_u(np.arange(g.n_u),
                                                 min_degree_v=2)[0]
        a[k, sub.edges_u, sub.edges_v] = 1.0
    return torch.from_numpy(a)


STACK_LABEL = "stack launch "


def stack_launches(torch, bfly, bsp, shapes):
    """Wrap the wrappers of kernels 2, 5 and 3 (the engine reaches them
    through these module attributes) so that each call appends its kernel
    and (G, m, n_v) to ``shapes`` and runs inside a profiler range named
    after them (``where_the_time_goes`` reads each range's device time).
    The wrapped functions still count their own launches.  Returns a
    function that puts the originals back."""
    originals = [(bfly, "butterfly_update_batched"),
                 (bsp, "butterfly_update_sparse_batched"),
                 (bsp, "b2_stack")]
    saved = [getattr(mod, fname) for mod, fname in originals]

    def wrap(fn, fname):
        def call(a, *args, **kwargs):
            label = f"{fname} (G, m, n_v) = {tuple(a.shape)}"
            shapes.append(label)
            with torch.profiler.record_function(STACK_LABEL + label):
                return fn(a, *args, **kwargs)
        return call

    for (mod, fname), fn in zip(originals, saved):
        setattr(mod, fname, wrap(fn, fname))

    def restore():
        for (mod, fname), fn in zip(originals, saved):
            setattr(mod, fname, fn)
    return restore


def where_the_time_goes(torch, run, top: int = 8):
    """Two more runs of the full-size path: one under ``torch.profiler``
    (device kernel time by name, and its share of the run's wall time),
    one under ``cProfile`` (host time by function of the port)."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    from torch.autograd import DeviceType

    def device_us(e):
        return e.self_device_time_total

    # device-side activities only (a CPU op such as aten::copy_ also
    # carries the device time of what it launched: counting both would
    # count that time twice); the profiler's own buffer events are not
    # the program's
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0
                   and not e.key.startswith(("Activity Buffer",
                                             STACK_LABEL))),
                  key=device_us, reverse=True)
    copies = sum(device_us(e) for e in rows
                 if e.key.startswith(("Memcpy", "Memset"))) / 1e6
    busy = sum(device_us(e) for e in rows) / 1e6
    log(f"profile: wall {wall:.3f} s under torch.profiler; device busy "
        f"{busy:.3f} s = {busy / wall:.3f} of wall (idle share "
        f"{1 - busy / wall:.3f}): kernels {busy - copies:.3f} s, "
        f"memcpy/memset {copies:.3f} s")
    for e in rows[:top]:
        log(f"  device {device_us(e) / 1e3:10.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    # each call of kernels 2, 3 and 5, as annotated by stack_launches: the
    # profiler's range of the call on the card's timeline, and the device
    # time of the kernels that ran inside it (one stream: the call's own)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(STACK_LABEL)]
    for span in events:
        if (span.device_type != DeviceType.CUDA
                or not span.name.startswith(STACK_LABEL)):
            continue
        t0, t1 = span.time_range.start, span.time_range.end
        inside = [e for e in kernels
                  if t0 <= e.time_range.start and e.time_range.end <= t1]
        names = sorted({(re.search(r"\w+_kernel\w*", e.name)
                         or re.search(r"\w+", e.name)).group(0)
                        for e in inside})
        log(f"  call {span.name[len(STACK_LABEL):]}: device "
            f"{sum(e.time_range.elapsed_us() for e in inside) / 1e3:.4f} ms "
            f"in {len(inside)} kernels ({', '.join(names)}), over a "
            f"{span.time_range.elapsed_us() / 1e3:.4f} ms range")
    prof_host = cProfile.Profile()
    prof_host.enable()
    run()
    torch.cuda.synchronize()
    prof_host.disable()
    out = io.StringIO()
    pstats.Stats(prof_host, stream=out).sort_stats("cumulative").print_stats(
        "repro_torch", 16)
    root = str(Path(__file__).resolve().parent) + "/"
    for line in out.getvalue().splitlines():
        if "repro_torch" in line or "ncalls" in line:
            log("  host " + line.strip().replace(root, ""))


def counted(torch, ops, launches, pname, run):
    """Drive one path with every launch count set to 0 just before and
    read just after (into ``launches[pname]``); returns (result, wall s,
    max_memory_allocated bytes of the run)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[pname] = ops.launch_counts()
    return out, wall, torch.cuda.max_memory_allocated()


def executor_phase(torch, np, dev, g_full, want, fleet, launches,
                   EngineConfig, Executor, exact_theta, bup_oracle, ops,
                   small, powerlaw_bipartite):
    """Phase 5b: the port's entry point, ``repro_torch.api``, on the card.

    ``Executor.decompose`` at full size (cold, then a cache hit on a
    vertex-permuted copy; the config's ``representation="auto"`` must
    pick dense), the admission-forced tiled route, ``Executor.map`` on
    MAP_GROUPS cohort graphs on three kernel routes (cold fleet, then a
    warm one), and ``verify=True`` on phase 4's graphs and sp_mid.
    Every theta is held to an exact oracle.
    """
    cfg = EngineConfig(num_partitions=FULL["partitions"],
                       backend="cuda_sparse", cd_dispatch="graph")
    ex = Executor(cfg)
    if ex.device.type != "cuda":
        raise AssertionError("Executor() without a device must run on the "
                             "card")
    t0 = time.perf_counter()
    plan = ex.plan(g_full)
    plan_s = time.perf_counter() - t0
    log(f"executor: plan of the full-size graph in {plan_s:.4f} s "
        f"(Executor.plan alone)\n" + plan.describe())
    occ = plan.cost_model["tile_occupancy"]
    if plan.representation != "dense":
        raise AssertionError(f"representation='auto' routed "
                             f"{plan.representation} at occupancy {occ}")
    log(f"executor: representation='auto' -> dense (occupancy {occ:.4f} at "
        f"{plan.cost_model['tile_blocks']} tiles; rule: tiled at <= "
        f"{plan.cost_model['occupancy_crossover']} and >= "
        f"{plan.cost_model['min_dense_cells']} dense cells)")
    rng = np.random.default_rng(1)
    pu, pv = rng.permutation(g_full.n_u), rng.permutation(g_full.n_v)
    g_perm = type(g_full).from_edges(g_full.n_u, g_full.n_v,
                                     pu[g_full.edges_u], pv[g_full.edges_v])
    want_perm = np.empty_like(want)
    want_perm[pu] = want
    runs = (("executor_cold", g_full, want, plan),
            ("executor_hit", g_perm, want_perm, None))
    for pname, g, want_g, pl in runs:
        if pl is None:
            t0 = time.perf_counter()
            pl = ex.plan(g)
            plan_s = time.perf_counter() - t0
        td, wall, peak = counted(torch, ops, launches, pname,
                                 lambda: ex.decompose(g, plan=pl))
        if not np.array_equal(td.theta, want_g):
            raise AssertionError(f"{pname}: theta differs from the exact "
                                 "oracle")
        st = td.stats
        log(f"{pname}: theta == exact oracle | planning {plan_s:.4f} s, "
            f"wall {wall:.3f} s (time_cd {st.time_cd:.3f}, time_fd "
            f"{st.time_fd:.3f}) | host_round_trips {st.host_round_trips} | "
            f"rho_cd {st.rho_cd} rho_fd {st.rho_fd} wedges_cd "
            f"{st.wedges_cd} wedges_fd {st.wedges_fd} dgm_device_compactions"
            f" {st.dgm_device_compactions} | cache_stats {ex.cache_stats} | "
            f"measured cd_peel_width {pl.measured.cd_peel_width}, "
            f"{len(pl.measured.fd_level_widths)} FD widths, runs "
            f"{pl.measured.runs}")
        log(f"{pname}: plan.padded_bytes {pl.padded_bytes} | "
            f"max_memory_allocated {peak} bytes (ratio "
            f"{peak / pl.padded_bytes:.3f}) | launches {launches[pname]}")
    if ex.cache_stats["hits"] != 1:
        raise AssertionError(f"the permuted copy missed the cache: "
                             f"{ex.cache_stats}")

    # the forced tiled route: a budget between the tile list's estimate
    # and the dense matrix's fixed bytes (at 64-wide tiles: at 128 x 512
    # the estimate exceeds the dense bytes on this graph)
    probe = Executor(dataclasses.replace(
        cfg, kernel_blocks=TILED_ADMISSION_BLOCKS)).plan(g_full).cost_model
    budget = (probe["tiled_bytes"] + probe["dense_fixed_bytes"]) // 2
    ex_t = Executor(dataclasses.replace(
        cfg, kernel_blocks=TILED_ADMISSION_BLOCKS,
        memory_budget_bytes=int(budget)))
    t0 = time.perf_counter()
    pl = ex_t.plan(g_full)
    plan_s = time.perf_counter() - t0
    if pl.representation != "tiled":
        raise AssertionError(f"admission did not route tiled:\n"
                             f"{pl.describe()}")
    td, wall, peak = counted(torch, ops, launches, "executor_tiled",
                             lambda: ex_t.decompose(g_full, plan=pl))
    if not np.array_equal(td.theta, want):
        raise AssertionError("executor_tiled: theta differs from the exact "
                             "oracle")
    if launches["executor_tiled"]["butterfly_update_tiled[peel]"] <= 0:
        raise AssertionError("executor_tiled: kernel 6 never launched")
    log(f"executor_tiled: budget {budget} bytes between tiled "
        f"{probe['tiled_bytes']} and dense fixed "
        f"{probe['dense_fixed_bytes']} (blocks {TILED_ADMISSION_BLOCKS}, "
        f"{probe['n_tiles']} tiles) -> {pl.representation}; theta == exact "
        f"oracle | planning {plan_s:.4f} s, wall {wall:.3f} s, "
        f"host_round_trips {td.stats.host_round_trips}, rho_fd "
        f"{td.stats.rho_fd} | padded_bytes {pl.padded_bytes} | "
        f"max_memory_allocated {peak} | launches "
        f"{launches['executor_tiled']}")

    # Executor.map: 128 cohort graphs, one (1024, 512) bucket, one chunk
    t0 = time.perf_counter()
    want_fleet = [exact_theta(g) for g in fleet]
    warm = [powerlaw_bipartite(*MAP_FLEET, seed=500 + k)
            for k in range(MAP_GROUPS)]
    want_warm = [exact_theta(g) for g in warm]
    log(f"map: exact oracles of {2 * MAP_GROUPS} graphs in "
        f"{time.perf_counter() - t0:.1f} s; max support "
        f"{max(w[1] for w in want_fleet + want_warm)}")
    if max(w[1] for w in want_fleet + want_warm) >= EXACT_LIMIT:
        raise AssertionError("a fleet support is past 2^24")
    for pname, backend, mode in (("map_cuda", "cuda", "auto"),
                                 ("map_cuda_sparse", "cuda_sparse", "auto"),
                                 ("map_cuda_sparse_b2", "cuda_sparse",
                                  "b2")):
        exm = Executor(EngineConfig(backend=backend, fd_update_mode=mode))
        mapped = {}
        for what, graphs, wants in (("cold", fleet, want_fleet),
                                    ("warm", warm, want_warm)):
            key = pname if what == "cold" else f"{pname}_warm"
            res, wall, peak = counted(torch, ops, launches, key,
                                      lambda: exm.map(graphs, strict=True))
            bad = [k for k, (r, w) in enumerate(zip(res, wants))
                   if not np.array_equal(r.theta, w[0])]
            if bad:
                raise AssertionError(f"{key}: theta differs from the exact "
                                     f"oracle on members {bad[:8]}")
            mapped[what] = res
            rep = exm.last_map_report
            hit_rate = rep["cache_hits"] / max(
                rep["cache_hits"] + rep["cache_misses"], 1)
            if what == "warm" and hit_rate != 1.0:
                raise AssertionError(f"{key}: cache hit rate {hit_rate}")
            if rep["groups"] != 1 or rep["chunks"] != 1:
                raise AssertionError(f"{key}: expected one bucket and one "
                                     f"chunk, got {rep}")
            log(f"{key}: {len(graphs)} graphs, theta == exact oracle | wall "
                f"{wall:.3f} s | groups {rep['groups']} chunks "
                f"{rep['chunks']} counting_dispatches "
                f"{rep['counting_dispatches']} device_loop_calls "
                f"{rep['device_loop_calls']} host_round_trips "
                f"{rep['host_round_trips']} cache hit rate {hit_rate:.3f} "
                f"(chunk shapes seen before; kept for parity, nothing is "
                f"reused) | "
                f"max rho_fd {max(r.stats.rho_fd for r in res)} | "
                f"max_memory_allocated {peak} | launches "
                + str({k: v for k, v in launches[key].items() if v}))
            if what == "cold":
                # where a fleet's time goes: two more runs, profiled
                where_the_time_goes(torch, lambda: exm.map(graphs), top=5)
        for k in range(4):
            one = exm.decompose(fleet[k])
            if not np.array_equal(one.theta, mapped["cold"][k].theta):
                raise AssertionError(f"{pname}: member {k} differs from its "
                                     "own Executor.decompose")
        log(f"{pname}: members 0-3 bit-identical to their own "
            "Executor.decompose")
    del warm, want_warm, mapped, res

    # verify mode: the host float64 checker (a dense A A^T per boundary)
    # on phase 4's graphs and sp_mid, P = 8 (EngineConfig's default)
    checks = {}
    sp_mid = powerlaw_bipartite(4096, 4096, 24000, seed=14)
    runs = [(gname, g, b) for gname, g in small.items()
            for b in ("cuda", "cuda_sparse")]
    runs.append(("sp_mid", sp_mid, "cuda_sparse"))
    for gname, g, backend in runs:
        t0 = time.perf_counter()
        td = Executor(EngineConfig(backend=backend)).decompose(g,
                                                               verify=True)
        want_g = (exact_theta(g) if gname == "sp_mid" else bup_oracle(g))[0]
        if not (td.stats.verified and np.array_equal(td.theta, want_g)):
            raise AssertionError(f"verify {gname} {backend}: theta or the "
                                 "verification failed")
        checks[f"{gname}/{backend}"] = (
            td.stats.verify_checks, round(time.perf_counter() - t0, 3))
    log(f"verify=True, theta exact (checks, s with the check): {checks}")

    # each path launched the bodies it should, and no f32 tile body
    must = {"executor_cold": ("butterfly_update_sparse[count]",
                              "butterfly_update_sparse[peel]",
                              "butterfly_update_sparse_batched[peel]"),
            "executor_tiled": ("butterfly_update_tiled[peel]",),
            "map_cuda": ("butterfly_update_batched[peel]",),
            "map_cuda_sparse": ("butterfly_update_sparse_batched[peel]",),
            "map_cuda_sparse_b2": ("butterfly_update_sparse_batched[peel]",
                                   "b2_stack[pairs]")}
    for pname, keys in must.items():
        idle = [k for k in keys if launches[pname][k] <= 0]
        if idle:
            raise AssertionError(f"{pname}: {idle} never launched")
    for pname in ("executor_cold", "executor_hit", "executor_tiled",
                  *(p_ + w for p_ in ("map_cuda", "map_cuda_sparse",
                                      "map_cuda_sparse_b2")
                    for w in ("", "_warm"))):
        tile = [k for k, n in launches[pname].items()
                if (k.endswith("[tile]") or k == "butterfly_update_tiled"
                    "[count]") and n]
        if tile:
            raise AssertionError(f"{pname}: launched {tile}")


def main() -> int:
    import torch

    # ---- 1. card ------------------------------------------------------ #
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.api import EngineConfig, Executor, Planner
    from repro_torch.core.engine import DeviceGraph, ReceiptConfig
    from repro_torch.core.engine.tiled import build_tiled
    from repro_torch.core.graph import (BipartiteGraph, paper_fig1_graph,
                                        powerlaw_bipartite)
    from repro_torch.core.peeling import bup_oracle
    from repro_torch.core.receipt import parb_tip_decompose, tip_decompose
    from repro_torch.kernels import _build, butterfly as bfly
    from repro_torch.kernels import butterfly_sparse as bsp
    from repro_torch.kernels import butterfly_tiled as btl
    from repro_torch.kernels import ops

    # the plain versions' float32 products stay full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # ---- 2. build ----------------------------------------------------- #
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s")
    for path in libs.values():
        rep = path.with_suffix(".log")
        if rep.exists():
            for line in rep.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log("  ptxas:", line.strip())

    # ---- 3. kernel vs plain at the main paths' shapes ----------------- #
    g_full = powerlaw_bipartite(FULL["n_u"], FULL["n_v"], FULL["m"],
                                seed=FULL["seed"])
    paths = {
        "dense_subset": ReceiptConfig(num_partitions=FULL["partitions"]),
        "sparse_graph": ReceiptConfig(num_partitions=FULL["partitions"],
                                      backend="cuda_sparse",
                                      cd_dispatch="graph"),
        "tiled": ReceiptConfig(num_partitions=FULL["partitions"],
                               representation="tiled"),
        "parb": ReceiptConfig(),
    }
    cfg_sparse = paths["sparse_graph"]
    blocks = cfg_sparse.kernel_blocks
    bi, bj, bk = blocks
    # the degree-descending relabel tip_decompose applies before CD, so
    # phase 3 sees the main paths' own matrix (and, from the sparse
    # backend's DeviceGraph, its staircase extents)
    dg = DeviceGraph(g_full.relabel_by_degree(),
                     np.arange(g_full.n_u), cfg_sparse, device=dev)
    log(f"full graph: {g_full.m} distinct edges, device matrix "
        f"{tuple(dg.a.shape)} after DGM ({dg.n_cols} live columns)")
    rng = np.random.default_rng(0)
    results = {}

    def live_stripe_ops(kmax_a, kmax_b, n_v):
        """Operations of the product over the live stripes only, summed
        over (bi, bj) tile pairs, and the skipped share of the stripes."""
        n_k = -(-n_v // bk)
        pair = torch.minimum(kmax_a[..., :, None],
                             kmax_b[..., None, :]).clamp(max=n_k).double()
        live = float(pair.sum())
        return 2.0 * bi * bj * bk * live, 1.0 - live / (pair.numel() * n_k)

    def live_stripe_bytes(kmax_a, kmax_b, n_a, n_b, n_v, same=False):
        """f32 bytes of the operands' live stripes, each read once: row
        tile i of A is needed up to min(kmax_a[i], max_j kmax_b[j])
        stripes, row tile j of B likewise.  With ``same`` (B is A, with the
        same tiles) the one operand counts once, each tile to the farther
        of its two reaches."""
        n_k = -(-n_v // bk)
        ka = kmax_a.long().clamp(max=n_k)
        kb = kmax_b.long().clamp(max=n_k)
        reach_a = torch.minimum(ka, kb.amax(dim=-1, keepdim=True))
        reach_b = torch.minimum(kb, ka.amax(dim=-1, keepdim=True))

        def tile_bytes(reach, n_rows, block):
            tiles = torch.arange(reach.shape[-1], device=reach.device)
            rows = (n_rows - tiles * block).clamp(max=block)
            return 4.0 * float((rows * (reach * bk).clamp(max=n_v)).sum())

        if same:
            return tile_bytes(torch.maximum(reach_a, reach_b), n_a, bi)
        return tile_bytes(reach_a, n_a, bi) + tile_bytes(reach_b, n_b, bj)

    def measure(key, kernel, plain, product, ops_, nbytes, reps, old=None,
                old_bound=None, int8_product=None):
        """Hold ``kernel`` against ``plain`` (torch.equal) and time both and
        ``product``; with ``old`` (the body a redesigned form replaced, on
        the same operands) hold and time that too, in the same run, and
        print ``old_bound`` (ops, bytes), the bound as an earlier PR
        counted it, beside the bound; with ``int8_product`` time that
        product too (a yardstick only: the port never calls it).  Returns
        the device time per call of each CUDA kernel one call launches
        (profiler; with ``old`` only, else empty)."""
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{key}: kernel differs from its plain version, max abs "
                f"err {(got - want).abs().max().item()}")
        err = float((got - want).abs().max().item()) if got.numel() else 0.0
        old_ms = None
        if old is not None:
            if not torch.equal(old(), want):
                raise AssertionError(f"{key}: the old body differs from the "
                                     "plain version")
            old_ms = time_ms(torch, old, max(3, reps // 2))
        ms = time_ms(torch, kernel, reps)
        plain_ms = time_ms(torch, plain, max(3, reps // 4))
        prod_ms = time_ms(torch, product, reps)
        int8_ms = (time_ms(torch, int8_product, reps) if int8_product
                   else None)
        b_ms, b_by = bound(ops_, nbytes)
        ob_ms, ob_by = (bound(*old_bound) if old_bound is not None
                        else (None, None))
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            earlier_bound_ms=ob_ms,
                            product_only_ms=prod_ms,
                            int8_product_only_ms=int8_ms, old_body_ms=old_ms)
        extra = ""
        parts = {}
        if old is not None:
            eager_ms = time_ms(torch, kernel, reps, eager=True)
            parts = kernel_device_ms(torch, kernel)
            extra += (f" old_body_ms={old_ms:.4f} eager_ms(host enqueue "
                      f"included)={eager_ms:.4f} launches: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        if old_bound is not None:
            extra += f" earlier_bound_ms={ob_ms:.6f} ({ob_by})"
        if int8_ms is not None:
            extra += (f" int8_mm_ms(torch._int_mm of the s8 copy, product "
                      f"only)={int8_ms:.4f}")
        log(f"{key}: torch.equal=True ms={ms:.4f} bound_ms={b_ms:.6f} "
            f"({b_by}){extra} plain_ms={plain_ms:.4f} matmul_ms(product "
            f"only, not the same function)={prod_ms:.4f}")
        return parts

    # kernel 1, counting form at the full-size matrix: the count body
    # (int8 wgmma over the tile pairs I <= J) against the tile body it
    # replaced; bound over the pairs the symmetric form needs, the full
    # square as the earlier bound; the int8 product of the s8 copy beside
    # the f32 one
    a = dg.a
    n_a, n_v = a.shape
    alive = (torch.arange(n_a, device=dev) < dg.n_rows).float()
    ids = dg.ids
    a8 = (a != 0).to(torch.int8)
    bytes1c = 4.0 * (n_a * n_v + 3 * n_a)
    log(f"butterfly_update[count]: {int((a != 0).any(dim=1).sum())} of "
        f"{n_a} rows hold a nonzero, {int((a != 0).any(dim=0).sum())} of "
        f"{n_v} columns")
    measure("butterfly_update[count]",
            lambda: bfly.butterfly_update(a, a, alive, ids, ids,
                                          body="count"),
            lambda: bfly.butterfly_update_plain(a, a, alive, ids, ids),
            lambda: torch.matmul(a, a.T),
            count_pair_ops(torch, a, alive), bytes1c, reps=10,
            old=lambda: bfly.butterfly_update(a, a, alive, ids, ids,
                                              body="tile"),
            old_bound=(2.0 * n_a * n_a * n_v, bytes1c),
            int8_product=lambda: torch._int_mm(a8, a8.T))
    # kernel 1, a CD peel update: 256 gathered rows with global ids (the
    # peel body; the count body, which it replaced, on the same operands)
    n_peel, width = 240, 256
    rows_np = np.zeros(width, np.int64)
    rows_np[:n_peel] = np.sort(rng.choice(dg.n_rows, n_peel, replace=False))
    rows = torch.as_tensor(rows_np, dtype=torch.int32, device=dev)
    valid = (torch.arange(width, device=dev) < n_peel).float()
    a_peel = a[rows.long()] * valid[:, None]
    ops1, bytes1, live1 = peel_live_work(torch, a, a_peel, valid)

    def live_stripes(b, s):
        """32-column stripes where a row of ``b`` with s mass holds a
        nonzero (the stripes the peel body reads)."""
        live = (b[s != 0] != 0).any(dim=0).to(torch.int8)
        live = torch.nn.functional.pad(live, (0, (-live.numel()) % 32))
        return int(live.reshape(-1, 32).any(dim=1).sum())

    log(f"butterfly_update[peel]: {live1:.0f} of {n_v} columns live, in "
        f"{live_stripes(a_peel, valid)} of {-(-n_v // 32)} stripes; "
        f"yardstick: a clone of the matrix ({4 * a.numel()} bytes read, as "
        f"many written) {time_ms(torch, lambda: a.clone(), 10):.4f} ms")
    measure("butterfly_update[peel]",
            lambda: bfly.butterfly_update(a, a_peel, valid, ids, rows),
            lambda: bfly.butterfly_update_plain(a, a_peel, valid, ids, rows),
            lambda: torch.matmul(a, a_peel.T), ops1, bytes1, reps=50,
            old=lambda: bfly.butterfly_update(a, a_peel, valid, ids, rows,
                                              body="tile"),
            old_bound=(2.0 * n_a * width * n_v,
                       4.0 * (n_a * n_v + width * n_v + 2 * width
                              + 2 * n_a)))
    # kernel 1 at ParB's own shape: its unsorted matrix (after the DGM of
    # its DeviceGraph), 128 gathered rows of which one is valid (ParB's
    # median peel set)
    dgp = DeviceGraph(g_full, np.arange(g_full.n_u), paths["parb"],
                      device=dev)
    ap = dgp.a
    rows_p = torch.zeros(128, dtype=torch.int32, device=dev)
    rows_p[0] = int(rng.integers(dgp.n_rows))
    valid_p = (torch.arange(128, device=dev) < 1).float()
    ap_peel = ap[rows_p.long()] * valid_p[:, None]
    ids_p = dgp.ids
    opsp, bytesp, livep = peel_live_work(torch, ap, ap_peel, valid_p)
    n_ap, n_vp = ap.shape
    log(f"butterfly_update[peel_parb]: matrix {tuple(ap.shape)}, "
        f"{livep:.0f} of {n_vp} columns live, in "
        f"{live_stripes(ap_peel, valid_p)} stripes")
    measure("butterfly_update[peel_parb]",
            lambda: bfly.butterfly_update(ap, ap_peel, valid_p, ids_p,
                                          rows_p),
            lambda: bfly.butterfly_update_plain(ap, ap_peel, valid_p, ids_p,
                                                rows_p),
            lambda: torch.matmul(ap, ap_peel.T), opsp, bytesp, reps=200,
            old=lambda: bfly.butterfly_update(ap, ap_peel, valid_p, ids_p,
                                              rows_p, body="tile"),
            old_bound=(2.0 * n_ap * 128 * n_vp,
                       4.0 * (n_ap * n_vp + 128 * n_vp + 2 * 128
                              + 2 * n_ap)))
    del dgp, ap, ap_peel
    # kernel 4, counting form at the full-size matrix, its real extents:
    # the count body against the tile body, as for kernel 1
    kmax = dg.kmax
    ops4, skip = live_stripe_ops(kmax, kmax, n_v)
    log(f"butterfly_update_sparse[count]: {skip:.3f} of the stripes skipped")
    bytes4c = (live_stripe_bytes(kmax, kmax, n_a, n_a, n_v, same=True)
               + 4.0 * (3 * n_a + kmax.numel()))
    measure("butterfly_update_sparse[count]",
            lambda: bsp.butterfly_update_sparse(a, a, alive, ids, ids, kmax,
                                                kmax, blocks=blocks,
                                                body="count"),
            lambda: bsp.butterfly_update_sparse_plain(
                a, a, alive, ids, ids, kmax, kmax, blocks=blocks),
            lambda: torch.matmul(a, a.T),
            count_pair_ops(torch, a, alive, kmax, blocks), bytes4c,
            reps=10,
            old=lambda: bsp.butterfly_update_sparse(
                a, a, alive, ids, ids, kmax, kmax, blocks=blocks,
                body="tile"),
            old_bound=(ops4, bytes4c),
            int8_product=lambda: torch._int_mm(a8, a8.T))
    del a8
    # kernel 4, a CD peel update: the same 256 gathered rows, B-side
    # extents gathered from the per-row extents (padding rows 0)
    kb_peel = bsp.gathered_tile_extents(dg.row_ext, rows, valid > 0, bj)
    ops4p, skip = live_stripe_ops(kmax, kb_peel, n_v)
    ops4l, bytes4l, live4 = peel_live_work(torch, a, a_peel, valid, kmax,
                                           kb_peel, blocks)
    log(f"butterfly_update_sparse[peel]: {skip:.3f} of the stripes skipped "
        f"by the extents; {live4:.0f} of {n_v} columns live")
    measure("butterfly_update_sparse[peel]",
            lambda: bsp.butterfly_update_sparse(a, a_peel, valid, ids, rows,
                                                kmax, kb_peel, blocks=blocks),
            lambda: bsp.butterfly_update_sparse_plain(
                a, a_peel, valid, ids, rows, kmax, kb_peel, blocks=blocks),
            lambda: torch.matmul(a, a_peel.T), ops4l, bytes4l, reps=50,
            old=lambda: bsp.butterfly_update_sparse(
                a, a_peel, valid, ids, rows, kmax, kb_peel, blocks=blocks,
                body="tile"),
            old_bound=(ops4p, live_stripe_bytes(kmax, kb_peel, n_a, width,
                                                n_v)
                       + 4.0 * (2 * width + 2 * n_a + kmax.numel()
                                + kb_peel.numel())))
    # kernel 2: a (16, 1024, 1024) FD stack against 128 gathered rows: the
    # stack peel body against the tile body it replaced; bound per group
    # over the live columns of the valid rows (peel_live_work), the full
    # product as the earlier bound
    g_n, mm, cc, w = 16, 1024, 1024, 128
    gen = torch.Generator(device="cpu").manual_seed(1)
    a3 = (torch.rand(g_n, mm, cc, generator=gen) < 0.02).float().to(dev)
    rows3 = torch.stack([torch.randperm(mm, generator=gen)[:w]
                         for _ in range(g_n)]).to(dev)
    valid3 = (torch.arange(w)[None, :]
              < torch.randint(1, w + 1, (g_n, 1), generator=gen)).float().to(dev)
    b3 = torch.take_along_dim(a3, rows3[:, :, None], dim=1) * valid3[:, :, None]
    ids3 = torch.arange(mm, dtype=torch.int32, device=dev).expand(
        g_n, mm).contiguous()
    rows3 = rows3.to(torch.int32).contiguous()
    ops2, bytes2 = stack_peel_live_work(torch, a3, b3, valid3)
    log(f"butterfly_update_batched[peel]: {int(valid3.sum())} valid of "
        f"{g_n * w} gathered rows; yardstick: a clone of the stack "
        f"({4 * a3.numel()} bytes read, as many written) "
        f"{time_ms(torch, lambda: a3.clone(), 20):.4f} ms")
    parts = measure(
        "butterfly_update_batched[peel]",
        lambda: bfly.butterfly_update_batched(a3, b3, valid3, ids3, rows3),
        lambda: bfly.butterfly_update_batched_plain(a3, b3, valid3, ids3,
                                                    rows3),
        lambda: torch.bmm(a3, b3.transpose(1, 2)), ops2, bytes2, reps=50,
        old=lambda: bfly.butterfly_update_batched(a3, b3, valid3, ids3, rows3,
                                                  body="tile"),
        old_bound=(2.0 * g_n * mm * w * cc,
                   4.0 * (g_n * mm * cc + g_n * w * cc + 2 * g_n * w
                          + 2 * g_n * mm)))
    update_ms = sum(v for k, v in parts.items() if "peel_update" in k)
    log(f"butterfly_update_batched[peel]: its main kernel reads the stack "
        f"({4 * a3.numel()} bytes) in "
        + (f"{update_ms:.4f} ms, {4 * a3.numel() / update_ms / 1e9:.3f} TB/s"
           if update_ms else "(not in the profile)"))
    # kernel 3: a (16, 1024, 1024) staircase stack with its real extents;
    # the row cuts fall down the rows, as in a degree-sorted subgraph; the
    # pairs body against the tile body it replaced; bound over the distinct
    # nonzero row pairs, the live stripes of every tile pair as the
    # earlier bound
    row_cut = torch.randint(0, cc + 1, (g_n, mm, 1), generator=gen).sort(
        dim=1, descending=True).values
    st = ((torch.rand(g_n, mm, cc, generator=gen) < 0.05)
          & (torch.arange(cc)[None, None, :] < row_cut)).float().to(dev)
    row_ext3 = bsp.row_extents_device(st, bk)
    kmax3 = bsp.tile_extents(row_ext3, bi).to(torch.int32).contiguous()
    ops3, skip = live_stripe_ops(kmax3, kmax3, cc)
    bytes3 = (live_stripe_bytes(kmax3, kmax3, mm, mm, cc, same=True)
              + 4.0 * (g_n * mm * mm + 2 * kmax3.numel()))
    out3 = torch.empty(g_n, mm, mm, device=dev)
    log(f"b2_stack[pairs]: {skip:.3f} of the stripes skipped; yardstick: "
        f"writing the (G, m, m) output once ({4 * out3.numel()} bytes, "
        f"zero_) {time_ms(torch, out3.zero_, 20):.4f} ms")
    del out3
    measure("b2_stack[pairs]",
            lambda: bsp.b2_stack(st, kmax3, kmax3, blocks=blocks),
            lambda: bsp.b2_stack_plain(st, kmax3, kmax3, blocks=blocks),
            lambda: torch.bmm(st, st.transpose(1, 2)),
            b2_pair_ops(torch, st, kmax3, kmax3, blocks), bytes3, reps=20,
            old=lambda: bsp.b2_stack(st, kmax3, kmax3, blocks=blocks,
                                     body="tile"),
            old_bound=(ops3, bytes3))
    # kernel 5: the same staircase stack against 128 gathered rows per
    # group, per-group extents gathered from the per-row extents: the
    # stack peel body against the tile body, as for kernel 2
    b5 = torch.take_along_dim(st, rows3.long()[:, :, None], dim=1) \
        * valid3[:, :, None]
    kb5 = bsp.batched_gathered_tile_extents(row_ext3, rows3, valid3 > 0, bj)
    ops5, skip = live_stripe_ops(kmax3, kb5, cc)
    ops5l, bytes5l = stack_peel_live_work(torch, st, b5, valid3, kmax3, kb5,
                                          blocks)
    log(f"butterfly_update_sparse_batched[peel]: {skip:.3f} of the stripes "
        "skipped by the extents")
    measure("butterfly_update_sparse_batched[peel]",
            lambda: bsp.butterfly_update_sparse_batched(
                st, b5, valid3, ids3, rows3, kmax3, kb5, blocks=blocks),
            lambda: bsp.butterfly_update_sparse_batched_plain(
                st, b5, valid3, ids3, rows3, kmax3, kb5, blocks=blocks),
            lambda: torch.bmm(st, b5.transpose(1, 2)), ops5l, bytes5l,
            reps=50,
            old=lambda: bsp.butterfly_update_sparse_batched(
                st, b5, valid3, ids3, rows3, kmax3, kb5, blocks=blocks,
                body="tile"),
            old_bound=(ops5, live_stripe_bytes(kmax3, kb5, mm, w, cc)
                       + 4.0 * (2 * g_n * w + 2 * g_n * mm + kmax3.numel()
                                + kb5.numel())))
    del a3, b3, st, b5
    # kernels 2 and 5 at Executor.map's counting form: the fleet's own
    # (128, 1024, 512) stack (phase 5b's cold fleet, degree-sorted and
    # DGM-compacted as map builds it), A = B, every row alive; bound: the
    # int8 tensor-core time of the full products (2 G m^2 n_v operations)
    # or the HBM time of reading the stack once (and writing out),
    # whichever is larger
    fleet = [powerlaw_bipartite(*MAP_FLEET, seed=100 + k)
             for k in range(MAP_GROUPS)]
    am = map_stack(np, fleet).to(dev)
    g_m, m_m, c_m = am.shape
    sm = torch.ones(g_m, m_m, device=dev)
    idsm = torch.arange(m_m, dtype=torch.int32, device=dev).expand(
        g_m, m_m).contiguous()
    kmm = bsp.tile_extents(bsp.row_extents_device(am, bk), bi).to(
        torch.int32).contiguous()
    ops_m = 2.0 * g_m * m_m * m_m * c_m
    bytes_m = 4.0 * (am.numel() + 2 * sm.numel() + idsm.numel())
    log(f"map counting form: stack {tuple(am.shape)}, "
        f"{int(am.sum().item())} nonzeros, {ops_m:.4g} operations, "
        f"{bytes_m:.4g} bytes")
    measure("butterfly_update_batched[map_count]",
            lambda: bfly.butterfly_update_batched(am, am, sm, idsm, idsm),
            lambda: bfly.butterfly_update_batched_plain(am, am, sm, idsm,
                                                        idsm),
            lambda: torch.bmm(am, am.transpose(1, 2)), ops_m, bytes_m,
            reps=10)
    measure("butterfly_update_sparse_batched[map_count]",
            lambda: bsp.butterfly_update_sparse_batched(
                am, am, sm, idsm, idsm, kmm, kmm, blocks=blocks),
            lambda: bsp.butterfly_update_sparse_batched_plain(
                am, am, sm, idsm, idsm, kmm, kmm, blocks=blocks),
            lambda: torch.bmm(am, am.transpose(1, 2)), ops_m, bytes_m,
            reps=10)
    # kernel 3 at map's b2 form (map_cuda_sparse_b2's level loop): the
    # same stack and the extents ops.b2_stack derives from it, a 512 MB
    # (128, 1024, 1024) output; bound over the distinct nonzero row pairs
    # (b2_pair_ops) or the stack read once and the output written once
    if not torch.equal(kmm, bsp.column_extents(am, bi, bk).to(torch.int32)):
        raise AssertionError("map_b2: the extents differ from the ones "
                             "ops.b2_stack derives")
    bytes_mb2 = 4.0 * (am.numel() + g_m * m_m * m_m + 2 * kmm.numel())
    measure("b2_stack[map_b2]",
            lambda: bsp.b2_stack(am, kmm, kmm, blocks=blocks),
            lambda: bsp.b2_stack_plain(am, kmm, kmm, blocks=blocks),
            lambda: torch.bmm(am, am.transpose(1, 2)),
            b2_pair_ops(torch, am, kmm, kmm, blocks), bytes_mb2, reps=10)
    del am, sm, idsm, kmm
    # the ragged stacks the engine may hand kernels 2, 3 and 5 (m and n_v
    # not multiples of any tile, rows of 1,000 floats), kernel 3 also at
    # bi != bj, the B side's extents rebuilt at bj as ops.b2_stack does:
    # each body torch.equal to its plain version (in a function, so that
    # nothing it allocates outlives it)
    def check_ragged():
        gr, mr, nr = 3, 777, 1000
        cut_r = torch.randint(0, nr + 1, (gr, mr, 1), generator=gen).sort(
            dim=1, descending=True).values
        ar = ((torch.rand(gr, mr, nr, generator=gen) < 0.05)
              & (torch.arange(nr)[None, None, :] < cut_r)).float().to(dev)
        ext_r = bsp.row_extents_device(ar, bk)
        rows_r = torch.randint(0, mr, (gr, w), generator=gen).to(dev)
        valid_r = (torch.rand(gr, w, generator=gen) < 0.5).float().to(dev)
        br = torch.take_along_dim(ar, rows_r[:, :, None], dim=1)
        ids_r = torch.arange(mr, dtype=torch.int32, device=dev).expand(
            gr, mr).contiguous()
        rows_r = rows_r.to(torch.int32).contiguous()
        ka_r = bsp.tile_extents(ext_r, bi).to(torch.int32).contiguous()
        kb_r = bsp.batched_gathered_tile_extents(ext_r, rows_r, valid_r > 0,
                                                 bj)
        want_b2 = bsp.b2_stack_plain(ar, None, None, blocks=None)
        ragged = {
            "butterfly_update_batched[peel]": (
                bfly.butterfly_update_batched(ar, br, valid_r, ids_r,
                                              rows_r),
                bfly.butterfly_update_batched_plain(ar, br, valid_r, ids_r,
                                                    rows_r)),
            "butterfly_update_sparse_batched[peel]": (
                bsp.butterfly_update_sparse_batched(
                    ar, br, valid_r, ids_r, rows_r, ka_r, kb_r,
                    blocks=blocks),
                bsp.butterfly_update_sparse_batched_plain(
                    ar, br, valid_r, ids_r, rows_r, ka_r, kb_r,
                    blocks=blocks)),
        }
        for blk in (blocks, (128, 64, 512), (64, 128, 256)):
            ragged[f"b2_stack[pairs] blocks {blk}"] = (
                ops.b2_stack(ar, blocks=blk), want_b2)
        for what, (got, want_r) in ragged.items():
            if not torch.equal(got, want_r):
                raise AssertionError(f"{what} at ({gr}, {mr}, {nr}): the "
                                     "kernel differs from its plain version")
        log(f"ragged stacks ({gr}, {mr}, {nr}): " + ", ".join(ragged)
            + ": torch.equal to the plain versions")

    check_ragged()

    # kernel 6 at the tiled path's own slot list: the degree-sorted graph
    # after the host DGM pre-compaction, in (max(bi, bj), bk) tiles
    sub = g_full.relabel_by_degree().induced_on_u(
        np.arange(g_full.n_u), min_degree_v=2)[0]
    tg = build_tiled(sub, paths["tiled"])

    def up(x):
        return torch.from_numpy(x).to(dev)

    td = up(tg.tile_data)
    tl = (up(tg.srow), up(tg.scol), up(tg.sptr), up(tg.pos))
    live6 = btl.slot_liveness(td)
    tbi, tbk = tg.block_rows, tg.block_k
    n_rt6, n_ct6 = tg.n_row_tiles, tg.n_col_tiles
    log(f"tiled slot list: {n_rt6} x {n_ct6} bands of {tbi} x {tbk}, "
        f"{tg.n_slots} slots ({int(live6.sum())} live), occupancy "
        f"{tg.fill_ratio():.4f}, payload {tg.tile_data.nbytes} bytes "
        f"(padded dense matrix {tg.dense_bytes()} bytes)")

    live_b = live6.bool()
    scol6 = tl[1].long()
    # live slots per column band, and which rows of each slot hold a nonzero
    col_live = torch.zeros(n_ct6, device=dev).index_add_(
        0, scol6, live_b.float())
    row_nz = (td != 0).any(dim=2)                         # (n_slots, bi)

    def tiled_work(s6):
        """Operations and bytes the mask form needs for this ``s``, counted
        per row y with s mass, and the share of the (band, slot) pairs of
        the Pallas grid the kernel skips.  Row y meets the other rows only
        in the column bands c where y itself holds a nonzero, in its live
        tile pos[band(y), c]; there it needs 2 bi bk operations for each
        live slot of column band c.  The live slots of those column bands
        (y's own tiles among them) are read once, as are s, out and the
        index arrays."""
        ys = torch.nonzero(s6).squeeze(1)
        p = tl[3].long()[ys // tbi].clamp(min=0)          # (n_y, n_ct)
        has = ((tl[3].long()[ys // tbi] >= 0) & live_b[p]
               & row_nz[p, (ys % tbi)[:, None]])
        ops_ = 2.0 * tbi * tbk * float((has.float() @ col_live).sum())
        n_tiles = int((live_b & has.any(dim=0)[scol6]).sum())
        nbytes = (4.0 * tbi * tbk * n_tiles + 4.0 * 2 * tg.rows_pad
                  + 4.0 * (3 * tg.n_slots + n_rt6 + 1 + n_rt6 * n_ct6))
        partner = tl[3].long()[:, scol6]                  # (n_rt, n_slots)
        ok = ((partner >= 0) & live_b[None, :]
              & live_b[partner.clamp(min=0)])
        band_mass = (s6.reshape(n_rt6, tbi) != 0).any(dim=1)
        skip = 1.0 - float((ok & band_mass[:, None]).sum()) / (
            n_rt6 * tg.n_slots)
        return ops_, nbytes, skip, n_tiles, int(has.sum())

    dense6 = up(tg.dense())
    rng6 = np.random.default_rng(6)
    # the count launch's mask (s = every alive row), then peel sets of 1
    # row (the median), 16, 64 and 256 rows: the peel body, the one the
    # tiled path launches for all of them, against the count body on the
    # same mask
    forms6 = {"alive": np.arange(sub.n_u)}
    for w6 in (1, 16, 64, 256):
        forms6[f"peel{w6}"] = rng6.choice(sub.n_u, w6, replace=False)
    for form, rows6 in forms6.items():
        s6 = torch.zeros(tg.rows_pad, device=dev)
        s6[torch.as_tensor(rows6, device=dev)] = 1.0
        ops6, bytes6, skip, n_tiles, n_meet = tiled_work(s6)
        key = f"butterfly_update_tiled[{form}]"
        log(f"{key}: {skip:.4f} of the (band, slot) pairs skipped by the "
            f"count body; the per-tile bound counts {n_meet} (row, column "
            f"band) meetings over {n_tiles} of {int(live_b.sum())} live "
            "tiles")
        b6 = dense6 if form == "alive" else dense6[
            torch.as_tensor(rows6, device=dev)]
        n6 = len(rows6)
        ops6c, bytes6c = tiled_peel_live_work(torch, td, tl[1], tl[3], live6,
                                              s6)
        measure(key,
                lambda s6=s6, n=n6: btl.butterfly_update_tiled(
                    td, *tl, live6, s6, n_srows=n),
                lambda s6=s6, n=n6: btl.butterfly_update_tiled_plain(
                    td, *tl, live6, s6, n_srows=n),
                lambda b6=b6: torch.matmul(dense6, b6.T),
                ops6c, bytes6c, reps=5 if form == "alive" else 50,
                old=lambda s6=s6: btl.butterfly_update_tiled(td, *tl, live6,
                                                             s6, body="count"),
                old_bound=(ops6, bytes6))
    # the tiled path's tile-list passes at this size, per call
    keep_cols = (btl.colsum_tiled(td, tl[1], n_ct6) >= 2.0).float()
    alive6 = (torch.arange(tg.rows_pad, device=dev) < sub.n_u).float()
    peel1 = torch.zeros(tg.rows_pad, device=dev)
    peel1[int(forms6["peel1"][0])] = 1.0
    td_copy = td.clone()
    passes = {
        "regather_tiles (in place, with liveness)": (lambda: btl.regather_tiles(
            td_copy, tl[0], tl[1], alive6, keep_cols), 20),
        "slot_liveness": (lambda: btl.slot_liveness(td), 20),
        "masked_colsum_tiled (1 row)": (
            lambda: btl.masked_colsum_tiled(td, tl[0], tl[1], tl[3], peel1),
            50),
    }
    for pname, (fn, reps) in passes.items():
        log(f"tile pass {pname}: {time_ms(torch, fn, reps):.4f} ms "
            f"({tg.tile_data.nbytes} payload bytes)")
    del td, td_copy, dense6, live6, row_nz

    # ---- 4. small end to end ------------------------------------------ #
    small = {"fig1": paper_fig1_graph(),
             "powerlaw": powerlaw_bipartite(200, 120, 1500, seed=5),
             "vhub": vhub_graph(BipartiteGraph)}
    for gname, g in small.items():
        for side in "UV":
            want = bup_oracle(g if side == "U" else g.transposed())[0]
            for backend in ("cuda", "cuda_sparse"):
                for dispatch in ("subset", "graph"):
                    for mode in ("b2", "kernel"):
                        theta, _ = tip_decompose(
                            g, ReceiptConfig(backend=backend,
                                             cd_dispatch=dispatch,
                                             fd_update_mode=mode),
                            side=side, device=dev)
                        if not np.array_equal(theta, want):
                            raise AssertionError(
                                f"small e2e {gname} side={side} "
                                f"backend={backend} cd_dispatch={dispatch} "
                                f"mode={mode}: theta differs from "
                                "bup_oracle")
            g_side = g if side == "U" else g.transposed()
            more = [(f"tiled backend={b}", lambda b=b: tip_decompose(
                        g, ReceiptConfig(backend=b, representation="tiled"),
                        side=side, device=dev)) for b in ("cuda",
                                                           "cuda_sparse")]
            more += [(f"fd_mode={m}", lambda m=m: tip_decompose(
                         g, ReceiptConfig(fd_mode=m), side=side, device=dev))
                     for m in ("b2", "matvec")]
            more += [(f"parb backend={b}", lambda b=b: parb_tip_decompose(
                         g_side, ReceiptConfig(backend=b), device=dev))
                     for b in ("cuda", "cuda_sparse")]
            for what, run in more:
                if not np.array_equal(run()[0], want):
                    raise AssertionError(
                        f"small e2e {gname} side={side} {what}: theta "
                        "differs from bup_oracle")
            log(f"small e2e {gname} side={side}: theta == bup_oracle "
                "(cuda, cuda_sparse) x (subset, graph) x (b2, kernel); "
                "tiled (cuda, cuda_sparse); fd_mode b2, matvec; parb (cuda, "
                "cuda_sparse)")

    # ---- 5. full size: both paths ------------------------------------- #
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"memory allocated before the full-size paths: "
        f"{torch.cuda.memory_allocated()} bytes")
    t0 = time.perf_counter()
    want, max_support = exact_theta(g_full)
    oracle_s = time.perf_counter() - t0
    if max_support >= EXACT_LIMIT:
        raise AssertionError(
            f"max butterfly support {max_support} is past the f32 integer "
            "regime (2^24)")
    log(f"full size: exact oracle {oracle_s:.1f} s on the host ({g_full.n_u} "
        f"vertices, max support {max_support})")
    launches, full_stats, full_walls = {}, {}, {}

    def run_path(pname, g, cfg):
        if pname == "parb":
            return parb_tip_decompose(g, cfg, device=dev)
        return tip_decompose(g, cfg, side="U", device=dev)

    for pname, cfg in paths.items():
        # the facade plans inside each run (api.decompose on a fresh
        # Executor); the same planning, timed apart, is logged beside
        plan_s = None
        if pname != "parb":
            t0 = time.perf_counter()
            Planner(cfg, device=dev).plan(g_full)
            plan_s = time.perf_counter() - t0
        shapes = []
        restore = stack_launches(torch, bfly, bsp, shapes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        theta, stats = run_path(pname, g_full, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[pname] = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if not np.array_equal(theta, want):
            bad = int((theta != want).sum())
            raise AssertionError(f"full size {pname}: theta differs from the "
                                 f"exact oracle on {bad} vertices")
        log(f"full size {pname}: theta == exact oracle (max theta "
            f"{int(theta.max())})")
        log(f"full size {pname}: planning {plan_s} s (timed apart)")
        log(f"full size {pname}: wall {wall:.3f} s | time_count "
            f"{stats.time_count:.3f} time_cd {stats.time_cd:.3f} time_fd "
            f"{stats.time_fd:.3f} s")
        log(f"full size {pname}: rho_cd {stats.rho_cd} rho_fd {stats.rho_fd} "
            f"num_subsets {stats.num_subsets} wedges_pvbcnt "
            f"{stats.wedges_pvbcnt} wedges_cd {stats.wedges_cd} wedges_fd "
            f"{stats.wedges_fd} huc_recounts {stats.huc_recounts} "
            f"elided_sweeps {stats.elided_sweeps} dgm_compactions "
            f"{stats.dgm_compactions} dgm_device_compactions "
            f"{stats.dgm_device_compactions} fd_groups {stats.fd_groups} "
            f"host_round_trips {stats.host_round_trips}")
        log(f"full size {pname}: launches {launches[pname]} | "
            f"max_memory_allocated {peak} bytes")
        log(f"full size {pname}: calls of kernels 2, 3 and 5: "
            + ("; ".join(shapes) if shapes else "none"))
        full_stats[pname] = stats
        full_walls[pname] = wall
        where_the_time_goes(torch, lambda: run_path(pname, g_full, cfg))
        restore()
    # each body ran where it should: the peel bodies on the peel updates,
    # the count bodies on counting and HUC recounts
    # (kernel 6 launches its peel body for its count launch too, and its
    # count body, the yardstick of phase 3, nowhere)
    must = {"dense_subset": ("butterfly_update[count]",
                             "butterfly_update[peel]",
                             "butterfly_update_batched[peel]",
                             "b2_stack[pairs]"),
            "parb": ("butterfly_update[count]", "butterfly_update[peel]"),
            "sparse_graph": ("butterfly_update_sparse[count]",
                             "butterfly_update_sparse[peel]",
                             "butterfly_update_sparse_batched[peel]",
                             "b2_stack[pairs]"),
            "tiled": ("butterfly_update_tiled[peel]",)}
    for pname, keys in must.items():
        idle = [k for k in keys if launches[pname][k] <= 0]
        if idle:
            raise AssertionError(f"full size {pname}: {idle} never launched")
        if launches[pname]["butterfly_update_tiled[count]"]:
            raise AssertionError(f"full size {pname}: kernel 6's count body "
                                 "launched")
        tile = [k for k, n in launches[pname].items()
                if k.endswith("[tile]") and n]
        if tile:
            raise AssertionError(f"full size {pname}: the f32 tile body "
                                 f"launched: {tile}")
    log("full size: kernel-1 launches by body (count, peel): "
        + ", ".join(f"{p_} ({launches[p_]['butterfly_update[count]']}, "
                    f"{launches[p_]['butterfly_update[peel]']})"
                    for p_ in paths))
    rho_tiled = full_stats["tiled"].rho_fd
    rho_parb = full_stats["parb"].rho_cd
    if rho_tiled != rho_parb:
        raise AssertionError(f"tiled rho_fd {rho_tiled} != ParB rho_cd "
                             f"{rho_parb}: the two run the same schedule")
    log(f"full size: tiled rho_fd {rho_tiled} == parb rho_cd {rho_parb}")

    # ---- 5b. the API layer: Executor.decompose and Executor.map ------- #
    executor_phase(torch, np, dev, g_full, want, fleet, launches,
                   EngineConfig, Executor, exact_theta, bup_oracle, ops,
                   small, powerlaw_bipartite)

    # ---- 6. crossover: staircase + graph against tiled ---------------- #
    # the full-size graph's walls are phase 5's timed runs: the kernels and
    # the allocator are warm by then (phases 3-4), and a second run there
    # measured no faster (PERF.md)
    ladder = {"sp_mid": powerlaw_bipartite(4096, 4096, 24000, seed=14),
              "sp_large": powerlaw_bipartite(8192, 8192, 32000, seed=15),
              "full": g_full}
    for gname, g in ladder.items():
        sub = g.relabel_by_degree().induced_on_u(np.arange(g.n_u),
                                                 min_degree_v=2)[0]
        tgx = build_tiled(sub, paths["tiled"])
        walls = {}
        if gname == "full":
            walls = {p_: full_walls[p_] for p_ in ("sparse_graph", "tiled")}
        else:
            want_x = exact_theta(g)[0]
            for pname in ("sparse_graph", "tiled"):
                for _ in range(2):       # the second run is the warm one
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    theta, _ = run_path(pname, g, paths[pname])
                    torch.cuda.synchronize()
                    walls[pname] = time.perf_counter() - t0
                if not np.array_equal(theta, want_x):
                    raise AssertionError(f"crossover {gname} {pname}: theta "
                                         "differs from the exact oracle")
        log(f"crossover {gname}: {g.n_u} x {g.n_v}, {g.m} edges; tiles "
            f"{tgx.n_row_tiles} x {tgx.n_col_tiles} of {tgx.block_rows} x "
            f"{tgx.block_k}, {tgx.n_slots} slots, occupancy "
            f"{tgx.fill_ratio():.4f}; warm wall sparse_graph "
            f"{walls['sparse_graph']:.4f} s, tiled {walls['tiled']:.4f} s "
            f"(tiled/sparse_graph {walls['tiled'] / walls['sparse_graph']:.3f});"
            " both exact")

    # ---- 7. kernel list ------------------------------------------------ #
    count_cu = "src/repro_torch/kernels/csrc/butterfly_count.cu"
    k1 = ("src/repro_torch/kernels/csrc/butterfly_sparse.cu",
          "src/repro/kernels/butterfly.py:125")
    k4 = ("src/repro_torch/kernels/csrc/butterfly_sparse.cu",
          "src/repro/kernels/butterfly_sparse.py:220")
    k6 = ("src/repro_torch/kernels/csrc/butterfly_tiled.cu",
          "src/repro/kernels/butterfly_tiled.py:259")
    # (launch key, phase-3 result, source, Pallas kernel replaced)
    table = [
        ("butterfly_update[count]", "butterfly_update[count]", count_cu,
         k1[1]),
        ("butterfly_update[peel]", "butterfly_update[peel]", *k1),
        ("butterfly_update[peel]", "butterfly_update[peel_parb]", *k1),
        ("butterfly_update_batched[peel]", "butterfly_update_batched[peel]",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly.py:225"),
        ("butterfly_update_batched[peel]",
         "butterfly_update_batched[map_count]",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly.py:225"),
        ("b2_stack[pairs]", "b2_stack[pairs]",
         "src/repro_torch/kernels/csrc/b2_stack.cu",
         "src/repro/kernels/butterfly_sparse.py:420"),
        ("b2_stack[pairs]", "b2_stack[map_b2]",
         "src/repro_torch/kernels/csrc/b2_stack.cu",
         "src/repro/kernels/butterfly_sparse.py:420"),
        ("butterfly_update_sparse[count]", "butterfly_update_sparse[count]",
         count_cu, k4[1]),
        ("butterfly_update_sparse[peel]", "butterfly_update_sparse[peel]",
         *k4),
        ("butterfly_update_sparse_batched[peel]",
         "butterfly_update_sparse_batched[peel]",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly_sparse.py:318"),
        ("butterfly_update_sparse_batched[peel]",
         "butterfly_update_sparse_batched[map_count]",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly_sparse.py:318"),
    ] + [("butterfly_update_tiled[peel]", f"butterfly_update_tiled[{form}]",
          *k6) for form in forms6]
    kernels = []
    for kname, key, source, replaces in table:
        r = results[key]
        by_path = {p_: launches[p_][kname] for p_ in launches}
        kernels.append(dict(
            name=key, route="cuda", source=source,
            replaces=replaces, launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            earlier_bound_ms=r["earlier_bound_ms"],
            product_only_ms=r["product_only_ms"],
            int8_product_only_ms=r["int8_product_only_ms"],
            old_body_ms=r["old_body_ms"]))
    log(json.dumps({"kernels": kernels}))
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on any full-size "
                             f"path: {idle}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
