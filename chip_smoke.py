#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # needs one CUDA card; 3 to 6 minutes

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
   stripe-skipping kernels, whose skipped share is printed, and over the
   live tile pairs the mask needs for the tiled kernel), the plain
   version's time and the time of the bare matrix product (product only,
   not the same function); and the times of the tiled path's tile-list
   passes (the in-place regather, the liveness, the column sums);
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
   rounds, and every kernel must have launched on at least one path; then
   each path but ParB twice more, under ``torch.profiler`` (device time by
   kernel, busy share of the wall) and ``cProfile`` (host time by
   function);
6. crossover: tile occupancy at the card's 128 x 512 tiles and the warm
   wall (second run) of the staircase + graph path against the tiled path
   on the sp_mid and sp_large graphs of the reference's benchmark ladder
   and on the full-size graph, both exact; recorded only, nothing routes
   by it;
7. the kernel list as one JSON line, then the result line.

It imports nothing of ``repro`` (the JAX package) or ``jax``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
INT8_OPS_PER_S = 1979e12     # 0/1 operands, counts < 2^24: exact in int8
HBM_BYTES_PER_S = 3.35e12
EXACT_LIMIT = 2 ** 24        # f32 integer regime (DESIGN.md section 8)

FULL = dict(n_u=6486, n_v=12942, m=96662, seed=0, partitions=150)


def log(*args):
    print(*args, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(ops: float, nbytes: float):
    """Least time (ms) the card needs for ``ops`` int8 tensor-core
    operations and ``nbytes`` of HBM traffic, and which one binds."""
    t_ops = ops / INT8_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


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
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side activities only (a CPU op such as aten::copy_ also
    # carries the device time of what it launched: counting both would
    # count that time twice); the profiler's own buffer events are not
    # the program's
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0
                   and not e.key.startswith("Activity Buffer")),
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


def main() -> int:
    import torch

    # ---- 1. card ------------------------------------------------------ #
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

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

    def measure(key, kernel, plain, product, ops_, nbytes, reps):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{key}: kernel differs from its plain version, max abs "
                f"err {(got - want).abs().max().item()}")
        err = float((got - want).abs().max().item()) if got.numel() else 0.0
        ms = time_ms(torch, kernel, reps)
        plain_ms = time_ms(torch, plain, max(3, reps // 4))
        prod_ms = time_ms(torch, product, reps)
        b_ms, b_by = bound(ops_, nbytes)
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            product_only_ms=prod_ms)
        log(f"{key}: torch.equal=True ms={ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}) plain_ms={plain_ms:.4f} matmul_ms(product only, not "
            f"the same function)={prod_ms:.4f}")

    # kernel 1, counting form at the full-size matrix
    a = dg.a
    n_a, n_v = a.shape
    alive = (torch.arange(n_a, device=dev) < dg.n_rows).float()
    ids = dg.ids
    measure("butterfly_update[count]",
            lambda: bfly.butterfly_update(a, a, alive, ids, ids),
            lambda: bfly.butterfly_update_plain(a, a, alive, ids, ids),
            lambda: torch.matmul(a, a.T),
            2.0 * n_a * n_a * n_v, 4.0 * (n_a * n_v + 3 * n_a), reps=10)
    # kernel 1, a CD peel update: 256 gathered rows with global ids
    n_peel, width = 240, 256
    rows_np = np.zeros(width, np.int64)
    rows_np[:n_peel] = np.sort(rng.choice(dg.n_rows, n_peel, replace=False))
    rows = torch.as_tensor(rows_np, dtype=torch.int32, device=dev)
    valid = (torch.arange(width, device=dev) < n_peel).float()
    a_peel = a[rows.long()] * valid[:, None]
    measure("butterfly_update[peel]",
            lambda: bfly.butterfly_update(a, a_peel, valid, ids, rows),
            lambda: bfly.butterfly_update_plain(a, a_peel, valid, ids, rows),
            lambda: torch.matmul(a, a_peel.T),
            2.0 * n_a * width * n_v,
            4.0 * (n_a * n_v + width * n_v + 2 * width + 2 * n_a), reps=50)
    # kernel 4, counting form at the full-size matrix, its real extents
    kmax = dg.kmax
    ops4, skip = live_stripe_ops(kmax, kmax, n_v)
    log(f"butterfly_update_sparse[count]: {skip:.3f} of the stripes skipped")
    measure("butterfly_update_sparse[count]",
            lambda: bsp.butterfly_update_sparse(a, a, alive, ids, ids, kmax,
                                                kmax, blocks=blocks),
            lambda: bsp.butterfly_update_sparse_plain(
                a, a, alive, ids, ids, kmax, kmax, blocks=blocks),
            lambda: torch.matmul(a, a.T),
            ops4, live_stripe_bytes(kmax, kmax, n_a, n_a, n_v, same=True)
            + 4.0 * (3 * n_a + kmax.numel()), reps=10)
    # kernel 4, a CD peel update: the same 256 gathered rows, B-side
    # extents gathered from the per-row extents (padding rows 0)
    kb_peel = bsp.gathered_tile_extents(dg.row_ext, rows, valid > 0, bj)
    ops4p, skip = live_stripe_ops(kmax, kb_peel, n_v)
    log(f"butterfly_update_sparse[peel]: {skip:.3f} of the stripes skipped")
    measure("butterfly_update_sparse[peel]",
            lambda: bsp.butterfly_update_sparse(a, a_peel, valid, ids, rows,
                                                kmax, kb_peel, blocks=blocks),
            lambda: bsp.butterfly_update_sparse_plain(
                a, a_peel, valid, ids, rows, kmax, kb_peel, blocks=blocks),
            lambda: torch.matmul(a, a_peel.T),
            ops4p, live_stripe_bytes(kmax, kb_peel, n_a, width, n_v)
            + 4.0 * (2 * width + 2 * n_a + kmax.numel() + kb_peel.numel()),
            reps=50)
    # kernel 2: a (16, 1024, 1024) FD stack against 128 gathered rows
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
    measure("butterfly_update_batched",
            lambda: bfly.butterfly_update_batched(a3, b3, valid3, ids3, rows3),
            lambda: bfly.butterfly_update_batched_plain(a3, b3, valid3, ids3,
                                                        rows3),
            lambda: torch.bmm(a3, b3.transpose(1, 2)),
            2.0 * g_n * mm * w * cc,
            4.0 * (g_n * mm * cc + g_n * w * cc + 2 * g_n * w + 2 * g_n * mm),
            reps=50)
    # kernel 3: a (16, 1024, 1024) staircase stack with its real extents;
    # the row cuts fall down the rows, as in a degree-sorted subgraph
    row_cut = torch.randint(0, cc + 1, (g_n, mm, 1), generator=gen).sort(
        dim=1, descending=True).values
    st = ((torch.rand(g_n, mm, cc, generator=gen) < 0.05)
          & (torch.arange(cc)[None, None, :] < row_cut)).float().to(dev)
    row_ext3 = bsp.row_extents_device(st, bk)
    kmax3 = bsp.tile_extents(row_ext3, bi).to(torch.int32).contiguous()
    ops3, skip = live_stripe_ops(kmax3, kmax3, cc)
    log(f"b2_stack: {skip:.3f} of the stripes skipped")
    measure("b2_stack",
            lambda: bsp.b2_stack(st, kmax3, kmax3, blocks=blocks),
            lambda: bsp.b2_stack_plain(st, kmax3, kmax3, blocks=blocks),
            lambda: torch.bmm(st, st.transpose(1, 2)),
            ops3, live_stripe_bytes(kmax3, kmax3, mm, mm, cc, same=True)
            + 4.0 * (g_n * mm * mm + 2 * kmax3.numel()), reps=20)
    # kernel 5: the same staircase stack against 128 gathered rows per
    # group, per-group extents gathered from the per-row extents
    b5 = torch.take_along_dim(st, rows3.long()[:, :, None], dim=1) \
        * valid3[:, :, None]
    kb5 = bsp.batched_gathered_tile_extents(row_ext3, rows3, valid3 > 0, bj)
    ops5, skip = live_stripe_ops(kmax3, kb5, cc)
    log(f"butterfly_update_sparse_batched: {skip:.3f} of the stripes "
        "skipped")
    measure("butterfly_update_sparse_batched",
            lambda: bsp.butterfly_update_sparse_batched(
                st, b5, valid3, ids3, rows3, kmax3, kb5, blocks=blocks),
            lambda: bsp.butterfly_update_sparse_batched_plain(
                st, b5, valid3, ids3, rows3, kmax3, kb5, blocks=blocks),
            lambda: torch.bmm(st, b5.transpose(1, 2)),
            ops5, live_stripe_bytes(kmax3, kb5, mm, w, cc)
            + 4.0 * (2 * g_n * w + 2 * g_n * mm + kmax3.numel()
                     + kb5.numel()), reps=50)
    del a3, b3, st, b5

    # kernel 6 at the tiled path's own slot list: the degree-sorted graph
    # after the host DGM pre-compaction, in (max(bi, bj), bk) tiles; the
    # count form, then two peel forms (1 row, the median peel set, and 16
    # rows, the widest of the plain version's gathered path)
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
    forms6 = {"count": np.arange(sub.n_u),
              "peel1": rng6.choice(sub.n_u, 1, replace=False),
              "peel16": rng6.choice(sub.n_u, 16, replace=False)}
    for form, rows6 in forms6.items():
        s6 = torch.zeros(tg.rows_pad, device=dev)
        s6[torch.as_tensor(rows6, device=dev)] = 1.0
        ops6, bytes6, skip, n_tiles, n_meet = tiled_work(s6)
        key = f"butterfly_update_tiled[{form}]"
        log(f"{key}: {skip:.4f} of the (band, slot) pairs skipped by the "
            f"kernel; the bound counts {n_meet} (row, column band) meetings "
            f"over {n_tiles} of {int(live_b.sum())} live tiles")
        b6 = dense6 if form == "count" else dense6[
            torch.as_tensor(rows6, device=dev)]
        measure(key,
                lambda s6=s6: btl.butterfly_update_tiled(td, *tl, live6, s6),
                lambda s6=s6, n=len(rows6): btl.butterfly_update_tiled_plain(
                    td, *tl, live6, s6, n_srows=n),
                lambda b6=b6: torch.matmul(dense6, b6.T),
                ops6, bytes6, reps=5 if form == "count" else 50)
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
        full_stats[pname] = stats
        full_walls[pname] = wall
        if pname != "parb":
            where_the_time_goes(torch, lambda: run_path(pname, g_full, cfg))
    rho_tiled = full_stats["tiled"].rho_fd
    rho_parb = full_stats["parb"].rho_cd
    if rho_tiled != rho_parb:
        raise AssertionError(f"tiled rho_fd {rho_tiled} != ParB rho_cd "
                             f"{rho_parb}: the two run the same schedule")
    log(f"full size: tiled rho_fd {rho_tiled} == parb rho_cd {rho_parb}")

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
    table = [
        ("butterfly_update", "butterfly_update[count]",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly.py:125"),
        ("butterfly_update", "butterfly_update[peel]",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly.py:125"),
        ("butterfly_update_batched", "butterfly_update_batched",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly.py:225"),
        ("b2_stack", "b2_stack",
         "src/repro_torch/kernels/csrc/b2_stack.cu",
         "src/repro/kernels/butterfly_sparse.py:420"),
        ("butterfly_update_sparse", "butterfly_update_sparse[count]",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly_sparse.py:220"),
        ("butterfly_update_sparse", "butterfly_update_sparse[peel]",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly_sparse.py:220"),
        ("butterfly_update_sparse_batched", "butterfly_update_sparse_batched",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly_sparse.py:318"),
    ] + [("butterfly_update_tiled", f"butterfly_update_tiled[{form}]",
          "src/repro_torch/kernels/csrc/butterfly_tiled.cu",
          "src/repro/kernels/butterfly_tiled.py:259")
         for form in ("count", "peel1", "peel16")]
    kernels = []
    for kname, key, source, replaces in table:
        r = results[key]
        by_path = {p_: launches[p_][kname] for p_ in paths}
        kernels.append(dict(
            name=key.replace("[count]", ""), route="cuda", source=source,
            replaces=replaces, launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            product_only_ms=r["product_only_ms"]))
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
