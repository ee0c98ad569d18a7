#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # needs one CUDA card; about 9-14 minutes

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
5c. the incremental re-peel: the full-size graph mutated at 1, 2 and 5%
   of its edges (the reference benchmark's rule: k inserts at low-degree
   endpoints and k deletes), ``Executor.repeel`` on ``"cuda"`` and
   ``"cuda_sparse"`` from supports maintained by the count body and
   ``vertex_support_edge_delta``, theta held to the exact oracle of the
   mutated graph and timed beside a from-scratch decompose; then kernels
   1 and 4 at the refresh's median peel set (the ``[peel_refresh]``
   rows);
5d. the edge axis: ``Executor(EngineConfig(workload="wing"))`` on sp_mid,
   both CD dispatches, psi held to an exact host oracle (a level peel
   with scipy int64 closed forms, ``exact_psi``), one profiled; the
   closed form timed at the full-size graph's wing matrix and sp_mid's
   FD stack against its float64 tensor-core bound; the wing refresh at
   1%.  Every executor run of phases 5b-5d holds its peak above resident
   to ``peak <= plan.padded_bytes <= 1.3 * peak``.  The host oracles of
   5c-5d run meanwhile in three worker processes started before phase 2;
5e. the decomposition service (``repro_torch.service``) on the card:
   ``DecompositionService(EngineConfig(num_partitions=150),
   ServiceConfig(refresh_dirty_threshold=0.12))`` on the full-size graph
   at each rung of 5c (ingest and flush, 5c's mutation, a timed flush:
   the delta path, theta exact, stop / subsets / sweeps equal to 5c's
   ``cuda`` rows), the same with the background worker (a read right
   after the 1% mutation returns the old version without blocking, the
   drained read is exact), phase 5b's cold fleet in one flush (one
   ``Executor.map`` fleet) and 16 members refreshed at 2%, an eviction
   under a 64-byte cache budget and its exact recompute, a counted worker
   crash under ``refresh_worker@2``, the wing on sp_mid with 5d's 1%
   mutation (stop and sweeps equal to 5d's), and
   ``repro_torch.launch.serve.main`` with the reference's CI lines;
5f. the distributed engine (``repro_torch.core.distributed``) on a
   (2, 2) ``("data", "model")`` mesh whose four shards share the card:
   ``Executor(..., mesh=mesh).decompose`` of the full-size graph on
   ``"cuda"`` and on ``"cuda_sparse"`` + graph dispatch (theta exact,
   ``rho_fd``/``wedges_fd`` equal to phase 5's, four shards with work on
   more than one, LPT loads within the list-scheduling bound, kernels 2
   (5) and 3 launched, the peak within the estimate), then the sharded
   count, sweep (both ``impl``s) and range loop on the sorted (8192,
   8192) matrix on (4, 1) and (2, 2) meshes, ``torch.equal`` to kernel
   1's single-device forms;
5g. the training substrate and the recsys path (``repro_torch.train``,
   ``models.recsys``, ``configs``, ``launch.train``), after the card is
   freed of the earlier phases' tensors (``mem_get_info`` printed): the
   recsys example's 12 spam-injected cohorts through ``Executor.map``
   (theta exact, kernel 2's counting form and kernel 3's b2 form
   launched, the recall and precision lines), then both kernels
   ``torch.equal`` to their plain versions and timed on the inputs the
   map handed them (the (16, 256, 512) cohort stack); the two-tower
   model at its full published widths
   (``get_bundle("two-tower-retrieval", reduced=False)``, 16.65 M table
   rows of 256) for 5 train steps at batch 8,192 (finite losses, step
   ms by CUDA events, the peak within 4 x the parameter bytes + 2 GB,
   untouched rows moved by weight decay alone within 1 ulp, one step
   profiled); ``train_loop`` at the reduced
   config checkpointed every 2 steps for 4 and resumed at step 4 (every
   restored leaf ``torch.equal``); 3 reduced steps on the card within
   rtol 1e-5 of the same steps on the CPU;
5h. the language-model serving path (``repro_torch.models`` attention,
   MoE and transformer, ``configs`` for the five LM archs,
   ``launch.serve_lm``), no hand kernel on it (every count stays 0):
   minitron-8b at its full published widths served by ``BatchedServer``
   (4 prompts of 8 tokens, 16 generated: finite logits, tokens in range,
   decode ms per step by CUDA events against the HBM bound of the bytes
   a step reads and writes (every weight but the embedding table's
   unread rows, the cache, the logits), the idle
   share under the profiler, the peak against P + cache), its prefill at
   (4, 2048) tokens timed, layer 0's flash attention against naive
   attention and the decode loop against ``lm_hidden`` + ``lm_logits``
   over 64 positions (bf16, relative L2 <= 5e-2); deepseek-v2-236b at
   full widths cut to 3 layers served the same way, its no-drop MoE
   decode against a per-token expert loop and ``mla_decode`` against
   ``mla_forward``; the five reduced archs on the card against the CPU
   (f32, 1e-4); ``serve_lm.main`` for each arch (phase ``lm_phase``);
5i. the training path of the GNN family and the LM (``models.gnn``,
   ``models.sampler``, the GNN batches and bundle, remat in
   ``models.transformer``, ``launch.train`` for every arch), no hand
   kernel on it (every count stays 0): the four GNNs at their full
   published widths on their registry cells, 3 train steps each (ms by
   CUDA events, the idle share under the profiler, the peak above
   resident, every param changed): GraphSAGE's ``train_sampled`` on
   ``minibatch_lg`` with the sampler on the card over its 232,965-node,
   114,615,892-edge graph (the card's neighbour table ``torch.equal`` to
   the host build, run in a worker started with phase 2's; sampled
   neighbours in their table rows), MeshGraphNet and GraphCast on
   ``minibatch_lg``'s graph view and grid, DimeNet on ``molecule``;
   minitron-8b at full widths cut to 4 layers trained at (1, 4,096)
   tokens with remat (ms per step, the peak against P + AdamW state +
   gradients + logits), remat on against off at 2 layers (equal losses,
   gradients within relative L2 1e-2); the reduced GNNs (and
   ``train_sampled``) on the card against the CPU (rtol 1e-4 / atol
   1e-5); ``train.main`` for all 10 archs (``gnn_lm_train_phase``);
5j. the sharding layer (``launch.mesh``, ``launch.sharding``, the
   Bundle's sharding methods, ``models.moe.moe_forward_sharded``), no
   hand kernel on it (every count stays 0): every arch's full-config
   param, state and input specs on the production meshes (16, 16) and
   (2, 16, 16) over meta devices, each leaf's piece shape dividing, the
   per-position bytes printed; minitron-8b's full params placed by
   ``lm_param_specs`` on a (2, 2) mesh of ``cuda:0`` positions (every
   piece a view: the peak above resident under 1% of P; ``unshard``
   ``torch.equal``); deepseek-v2-236b's MoE layer at its published
   widths on x (4, 2048, 5120) bf16 with cf = E / k, sharded over (2, 2)
   and (1, 4) meshes of ``cuda:0`` positions against the local path
   (relative L2 <= 5e-2; ms by CUDA events, the exchange bytes per
   position, the peak above resident), a backward at (2, 2048) (the
   gradients of x and of the routed weights within relative L2 1e-2);
   ``lm_prefill`` of deepseek-v2-236b cut to 3 layers at (4, 2048) under
   ``mesh_context`` of the (2, 2) mesh against the call without a mesh,
   capacity factor E / k in both (relative L2 <= 5e-2)
   (``sharding_phase``);
5k. the dry run (``repro_torch.launch.dryrun``): the whole CLI
   (``--all --multi-pod both``) in a pool worker started before phase 2,
   every record ``ok``, one line per cell and the worker's wall time;
   then four arms costed on a one-position meta mesh (in a pool worker)
   and run on the card: a CD sweep of ``_CDShards`` on a (1, 1) mesh
   (kernel 1's peel body), ``fd_stack_step`` on an (8, 2048, 8192) stack
   (kernel 3, the sequential peel), minitron-8b's decode step at phase
   5h's slots and cache length, its 4-layer train step at (1, 4096).
   Held: arguments within 1% of the bytes made resident, the peak within
   10% of ``max_memory_allocated``, the median ms (CUDA events) at least
   ``t_compute``, the decode's ``t_memory`` within 10% of phase 5h's
   bound; kernels 1 and 3 counted and ``torch.equal`` to their plain
   versions (``dryrun_phase``);
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
import multiprocessing
import re
import subprocess
import sys
import time
import types
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.launch.roofline import HBM_BW, PEAK_OPS  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), from the
# dry run's roofline: one source for both
INT8_OPS_PER_S = PEAK_OPS["int8"]   # 0/1 operands, counts < 2^24: exact
FP64_FLOP_PER_S = PEAK_OPS["fp64"]  # FP64 tensor cores (the edge closed form)
HBM_BYTES_PER_S = HBM_BW
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
# the incremental refresh: dirty fractions of the full-size graph's edges
# (k = round(frac * m / 2) inserts and as many deletes, the reference
# benchmark's rule), and of sp_mid's for the wing refresh
REFRESH_FRACS = (0.01, 0.02, 0.05)
WING_REFRESH_FRAC = 0.01
SP_MID = (4096, 4096, 24000, 14)
# the two-tower model at its full published widths: the batch is cut from
# the published train_batch of 65,536 (configs/shapes.py), whose (B, B)
# in-batch logits and their gradient would take 34 GB beside 68 GB of
# params, moments and gradients; RECSYS_DECAY_ROWS untouched rows of each
# table are held to the weight decay after step 1
RECSYS_BATCH = 8192
RECSYS_DECAY_ROWS = 4096
# the LM serving path (phase 5h): 4 slots, prompts of 8 tokens, 16
# generated; prefill at (4, 2048) tokens (4 q blocks x 2 kv blocks of the
# config's 512 / 1024); decode-vs-prefill over 64 positions; MLA
# decode-vs-forward over 16.  Every bf16 comparison (prefill vs decode,
# flash vs naive, the MoE decode vs a per-token expert loop, MLA decode vs
# forward) is held to a relative L2 error of at most LM_BF16_REL_L2; the
# card against the CPU at the reduced configs (f32, TF32 off) to rtol /
# atol LM_F32_TOL
LM_SLOTS, LM_PROMPT, LM_GEN = 4, 8, 16
LM_PROFILE_STEPS = 4
LM_PREFILL = (4, 2048)
LM_DECODE_CHECK = 64
LM_MLA_CHECK = 16
LM_BF16_REL_L2 = 5e-2
LM_F32_TOL = 1e-4
# deepseek-v2-236b at its published widths, its depth cut to 3 layers (1
# dense + 2 MoE: 9,330,795,840 parameters, 18.66 GB in bf16)
LM_V2_LAYERS = 3
# device memory a decode or prefill may hold above its params and cache
LM_ACT_SLACK = 2e9
# the GNN and LM training path (phase 5i): GNN_STEPS train steps of each
# GNN at full width on its registry cell (the GraphSAGE cell's graph from
# random_graph seed GNN_GRAPH_SEED, its neighbour table GNN_MAX_DEG wide,
# the reference builder's width); the card against the CPU at the reduced
# configs to rtol / atol GNN_F32_TOL; minitron-8b at full widths cut to
# LM_TRAIN_LAYERS layers for LM_TRAIN_STEPS steps at train_4k's sequence
# (batch 1); remat on against off at LM_REMAT_LAYERS layers, gradients
# within a relative L2 of LM_REMAT_REL_L2
GNN_STEPS = 3
GNN_GRAPH_SEED = 0
GNN_MAX_DEG = 32
GNN_F32_TOL = (1e-4, 1e-5)
LM_TRAIN_LAYERS = 4
LM_TRAIN_STEPS = 3
LM_REMAT_LAYERS = 2
LM_REMAT_REL_L2 = 1e-2
# the sharding path (phase 5j): deepseek-v2-236b's MoE layer at its
# published widths on x of SHARD_MOE_X tokens, sharded over the
# SHARD_MESHES meshes of cuda:0 positions against the local path, a
# backward at SHARD_MOE_BWD tokens (gradients within relative L2
# SHARD_GRAD_REL_L2); the placement of minitron-8b's full params may
# hold at most SHARD_PLACE_SLACK x P above resident (its pieces are views)
SHARD_MOE_X = (4, 2048)
SHARD_MOE_BWD = (2, 2048)
SHARD_MESHES = ((2, 2), (1, 4))
SHARD_GRAD_REL_L2 = 1e-2
SHARD_PLACE_SLACK = 0.01
# the dry run (phase 5k): its whole CLI in a pool worker (records in
# DRYRUN_OUT), and four calibration arms, each costed on a one-position
# meta mesh in a pool worker and run on the card: a CD sweep of CAL_CD
# (n_u, n_v, peel rows) at density CAL_CD_DENSITY (every 32-column stripe
# of the peel rows live, so the data-free count is the work done, and
# every support below 2^24, so kernel 1 equals its plain version
# bit for bit), kernel 3 and the sequential peel on a CAL_FD stack at
# density CAL_FD_DENSITY, minitron-8b's decode step at phase 5h's slots
# and cache length, and phase 5i's 4-layer train step at (1, 4,096).
# Held: predicted arguments within CAL_ARGS_TOL of the bytes made
# resident, the predicted peak within CAL_PEAK_TOL of
# max_memory_allocated, the measured ms (median of CAL_REPS after a
# warm-up, CUDA events) at least t_compute, and the decode arm's t_memory
# within CAL_DECODE_TOL of phase 5h's own bound at the same shapes
DRYRUN_OUT = "build/dryrun.json"
CAL_CD = (65536, 16384, 4096)
CAL_CD_DENSITY = 0.01
CAL_FD = (8, 2048, 8192)
CAL_FD_DENSITY = 0.5
CAL_REPS = 5
CAL_ARGS_TOL = 0.01
CAL_PEAK_TOL = 0.10
CAL_DECODE_TOL = 0.10


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


def first_calls(torch, targets):
    """Wrap each (module, function name) of ``targets`` so that its first
    call keeps clones of its tensor arguments and its keyword arguments,
    under the function's name, in the returned dict (the wrapped function
    still counts its own launch).  Returns (the dict, a function that puts
    the originals back)."""
    seen = {}
    saved = [getattr(mod, fname) for mod, fname in targets]

    def wrap(fn, fname):
        def call(*args, **kwargs):
            if fname not in seen:
                seen[fname] = ([a.detach().clone() if torch.is_tensor(a)
                                else a for a in args], dict(kwargs))
            return fn(*args, **kwargs)
        return call

    for (mod, fname), fn in zip(targets, saved):
        setattr(mod, fname, wrap(fn, fname))

    def restore():
        for (mod, fname), fn in zip(targets, saved):
            setattr(mod, fname, fn)
    return seen, restore


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
    max_memory_allocated bytes of the run, bytes resident before it)."""
    torch.cuda.synchronize()
    gc.collect()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches[pname] = ops.launch_counts()
    return out, wall, torch.cuda.max_memory_allocated(), resident


def exact_psi(n_u, n_v, edges_u, edges_v):
    """Exact wing numbers by a host level peel (the ParButterfly schedule
    on edges: every edge of the current minimum support level at once,
    then every survivor recounted, floored at the level) with the closed
    form b(u, v) = [A (A^T A)](u, v) - d_u - d_v + 1 from scipy sparse
    int64 products.  Imports nothing of the port.  Returns (psi int64,
    the largest support and the largest closed-form entry seen)."""
    import numpy as np
    import scipy.sparse as sp

    eu = np.asarray(edges_u, np.int64)
    ev = np.asarray(edges_v, np.int64)
    alive = np.ones(eu.size, bool)
    psi = np.zeros(eu.size, np.int64)
    biggest = [0, 0]

    def supports():
        a = sp.csr_matrix((np.ones(int(alive.sum()), np.int64),
                           (eu[alive], ev[alive])), shape=(n_u, n_v))
        m3 = (a @ (a.T @ a)).tocsr()
        du = np.asarray(a.sum(axis=1)).ravel()
        dv = np.asarray(a.sum(axis=0)).ravel()
        s = np.asarray(m3[eu, ev]).ravel() - du[eu] - dv[ev] + 1
        biggest[1] = max(biggest[1], int(m3.max()) if m3.nnz else 0)
        s = np.where(alive, s, 0)
        biggest[0] = max(biggest[0], int(s.max(initial=0)))
        return s

    sup = supports()
    k = 0
    while alive.any():
        k = max(k, int(sup[alive].min()))
        peel = alive & (sup <= k)
        psi[peel] = k
        alive &= ~peel
        if alive.any():
            sup = supports()
    return psi, biggest[0], biggest[1]


def exact_theta_of(n_u, n_v, edges_u, edges_v):
    """``exact_theta`` of a graph given as arrays (for a worker process)."""
    return exact_theta(types.SimpleNamespace(
        n_u=n_u, n_v=n_v, m=len(edges_u), edges_u=edges_u, edges_v=edges_v))


def service_mutations(np, g, count, rng):
    """``count`` inserts absent from ``g`` + ``count`` present deletes,
    both at LOW-degree endpoints: the reference benchmark's mutation rule
    (``benchmarks/bench_receipt.py``, ``_service_mutations``), copied.
    Returns (inserted (count, 2) int64, deleted edge indices)."""
    du = np.bincount(g.edges_u, minlength=g.n_u)
    dv = np.bincount(g.edges_v, minlength=g.n_v)
    u_pool = np.argsort(du)[: max(8, g.n_u // 4)]
    v_pool = np.argsort(dv)[: max(8, g.n_v // 4)]
    have = set((g.edges_u.astype(np.int64) * g.n_v + g.edges_v).tolist())
    ins = []
    while len(ins) < count:
        u = int(rng.choice(u_pool))
        v = int(rng.choice(v_pool))
        k = u * g.n_v + v
        if k not in have:
            have.add(k)
            ins.append((u, v))
    drop = np.argsort(du[g.edges_u] + dv[g.edges_v])[:count]
    return np.array(ins, np.int64).reshape(-1, 2), drop


def mutate(np, BipartiteGraph, g, frac, seed):
    """The mutated graph at ``frac``: k = round(frac * m / 2) inserts and
    k deletes (``service_mutations``).  Returns (g1, inserted, deleted
    (k, 2))."""
    k = max(1, int(round(frac * g.m / 2)))
    ins, drop = service_mutations(np, g, k, np.random.default_rng(seed))
    keep = np.ones(g.m, bool)
    keep[drop] = False
    g1 = BipartiteGraph.from_edges(
        g.n_u, g.n_v, np.concatenate([g.edges_u[keep], ins[:, 0]]),
        np.concatenate([g.edges_v[keep], ins[:, 1]]))
    dels = np.stack([g.edges_u[drop], g.edges_v[drop]], axis=1)
    return g1, ins, dels


def tip_refresh_inputs(torch, np, ops, dev, g0, ins, dels, theta_old,
                       bounds, backend):
    """What the reference service hands ``Executor.repeel``: supports of
    the base graph (kernel 1's or 4's count body), plus the inserts'
    gains and less the deletes' losses on the union matrix
    (``vertex_support_edge_delta``: two counting calls each), the stop
    ladder above the deletion ceiling (seeded with the inserted endpoints'
    stored numbers; the service's ``_ladder``) and the inserted U
    endpoints as the watch set."""
    from repro_torch.service.refresh import _ladder

    a = torch.zeros((g0.n_u, g0.n_v), device=dev)
    a[torch.as_tensor(g0.edges_u, device=dev).long(),
      torch.as_tensor(g0.edges_v, device=dev).long()] = 1.0
    from repro_torch.kernels.butterfly_sparse import column_extents

    blocks = (128, 128, 512)
    kmax = (column_extents(a, 128, 512) if backend == "cuda_sparse"
            else None)
    sup = ops.butterfly_support(a, torch.ones(g0.n_u, device=dev),
                                backend=backend, blocks=blocks, kmax=kmax)
    a[torch.as_tensor(ins[:, 0], device=dev),
      torch.as_tensor(ins[:, 1], device=dev)] = 1.0
    for rows, sign in ((ins, 1.0), (dels, -1.0)):
        sup = sup + sign * ops.vertex_support_edge_delta(
            a, torch.as_tensor(rows[:, 0], device=dev),
            torch.as_tensor(rows[:, 1], device=dev),
            torch.ones(len(rows), dtype=torch.bool, device=dev),
            backend=backend, blocks=blocks)
    t_known = float(theta_old[dels[:, 0]].max())
    seed = max(t_known, float(theta_old[ins[:, 0]].max()))
    return (sup.double().cpu().numpy(), _ladder(bounds, seed),
            np.unique(ins[:, 0]))


def wing_refresh_inputs(torch, np, ops, dev, g0, g1, ins, dels, psi_base,
                        bounds):
    """The reference service's wing arm: supports of the union graph in
    closed form, less the deleted slots' delta (before-minus-after), at
    the kept slots; the ladder above the deletion ceiling; the inserted
    edges as the watch set (their stored number a placeholder)."""
    from repro_torch.service.refresh import _ladder

    n_v = g0.n_v
    k0 = g0.edges_u.astype(np.int64) * n_v + g0.edges_v
    k1 = g1.edges_u.astype(np.int64) * n_v + g1.edges_v
    ki = ins[:, 0] * n_v + ins[:, 1]
    kd = dels[:, 0] * n_v + dels[:, 1]
    ku = np.sort(np.concatenate([k0, ki]))
    eu = torch.as_tensor(ku // n_v, device=dev)
    ev = torch.as_tensor(ku % n_v, device=dev)
    a = torch.zeros((g0.n_u, n_v), device=dev)
    a[eu, ev] = 1.0
    b = ops.edge_support_all(a, eu, ev)
    d = ops.edge_support_delta(
        a, eu, ev, torch.as_tensor(np.searchsorted(ku, kd), device=dev),
        torch.ones(kd.size, dtype=torch.bool, device=dev))
    sup = (b - d).double().cpu().numpy()[np.isin(ku, k1)]
    psi_old = np.zeros(g1.m, np.int64)
    in_base = np.isin(k1, k0)
    psi_old[in_base] = psi_base[np.searchsorted(k0, k1[in_base])]
    t_known = float(psi_base[np.searchsorted(k0, kd)].max())
    return sup, psi_old, _ladder(bounds, t_known), np.nonzero(
        np.isin(k1, ki))[0]


def check_admission(name, padded, peak):
    """The run's peak (above what was resident) must sit at or below the
    plan's estimate, and the estimate within 1.3x of it."""
    log(f"{name}: plan.padded_bytes {padded} | peak above resident {peak} "
        f"bytes | estimate / peak {padded / max(peak, 1):.3f}")
    if not peak <= padded <= 1.3 * peak:
        raise AssertionError(f"{name}: peak {peak} bytes against the "
                             f"estimate {padded} (must be <= it, within "
                             "1.3x)")


def executor_phase(torch, np, dev, g_full, want, fleet, launches,
                   EngineConfig, Executor, exact_theta, bup_oracle, ops,
                   small, powerlaw_bipartite):
    """Phase 5b: the port's entry point, ``repro_torch.api``, on the card.

    ``Executor.decompose`` at full size (cold, then a cache hit on a
    vertex-permuted copy; the config's ``representation="auto"`` must
    pick dense), the admission-forced tiled route, ``Executor.map`` on
    MAP_GROUPS cohort graphs on three kernel routes (cold fleet, then a
    warm one), and ``verify=True`` on phase 4's graphs and sp_mid.
    Every theta is held to an exact oracle.  Returns the cold fleet's
    oracle thetas (every map route was held equal to them).
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
        td, wall, peak, resident = counted(
            torch, ops, launches, pname, lambda: ex.decompose(g, plan=pl))
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
        log(f"{pname}: max_memory_allocated {peak} bytes | launches "
            f"{launches[pname]}")
        check_admission(pname, pl.padded_bytes, peak - resident)
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
    td, wall, peak, resident = counted(
        torch, ops, launches, "executor_tiled",
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
        f"{td.stats.rho_fd} | max_memory_allocated {peak} | launches "
        f"{launches['executor_tiled']}")
    check_admission("executor_tiled", pl.padded_bytes, peak - resident)

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
            res, wall, peak, _ = counted(
                torch, ops, launches, key,
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
    return [w[0] for w in want_fleet]


def refresh_phase(torch, np, dev, g_full, want, launches, oracles,
                  EngineConfig, Executor, ops, measure, mutations):
    """Phase 5c: ``Executor.repeel`` on the full-size graph, mutated by the
    reference benchmark's rule at each of ``REFRESH_FRACS`` (k inserts and
    k deletes at low-degree endpoints), on ``"cuda"`` (subset dispatch)
    and ``"cuda_sparse"`` (graph dispatch), P = 150: the base run's CD
    bounds make the ladder, the maintained supports come from the count
    body and ``vertex_support_edge_delta``; each refreshed theta is held
    to the exact oracle of the mutated graph (from the worker pool) and
    timed beside a from-scratch ``Executor.decompose`` of the same graph.
    Then phase 3's rows at refresh's shape: the median peel set of the
    smallest rung's refresh on its unsorted, column-compacted matrix,
    kernel 1's and kernel 4's peel bodies against their plain versions.
    Returns each refresh's stop, subsets, sweeps and walls by (backend,
    frac).
    """
    from repro_torch.core.engine import peel_loop
    from repro_torch.kernels import butterfly as bfly
    from repro_torch.kernels import butterfly_sparse as bsp
    from repro_torch.service.refresh import _mark_subsets

    calls, found = [], {}
    for backend, dispatch in (("cuda", "subset"), ("cuda_sparse", "graph")):
        ex = Executor(EngineConfig(num_partitions=FULL["partitions"],
                                   backend=backend, cd_dispatch=dispatch))
        base = ex.decompose(g_full)
        if not np.array_equal(base.theta, want):
            raise AssertionError(f"refresh base {backend}: theta differs")
        for frac in REFRESH_FRACS:
            g1, ins, dels = mutations[frac]
            pname = f"refresh_{backend}_{frac}"
            record = backend == "cuda" and frac == REFRESH_FRACS[0]
            real = peel_loop.support_delta

            def watched(a, a_peel, valid, ids, rows, *args, **kwargs):
                calls.append((a, rows, valid))
                return real(a, a_peel, valid, ids, rows, *args, **kwargs)

            def run():
                sup, stops, watch = tip_refresh_inputs(
                    torch, np, ops, dev, g_full, ins, dels, base.theta,
                    base.stats.bounds, backend)
                return ex.repeel(g1, sup0=sup, numbers_old=base.theta,
                                 stops=stops, watch=watch), stops

            if record:
                peel_loop.support_delta = watched
            try:
                ((theta, st), stops), wall, peak, resident = counted(
                    torch, ops, launches, pname, run)
            finally:
                peel_loop.support_delta = real
            want1 = oracles[("tip", frac)].result()[0]
            if not np.array_equal(theta, want1):
                raise AssertionError(f"{pname}: theta differs from the "
                                     "exact oracle of the mutated graph")
            _mark_subsets(st, base.stats.bounds)
            rep, total = (st.refresh_subsets_repeeled,
                          st.refresh_subsets_total)
            td, full_wall, full_peak, _ = counted(
                torch, ops, launches, f"{pname}_full",
                lambda: ex.decompose(g1))
            if not np.array_equal(td.theta, want1):
                raise AssertionError(f"{pname}: from-scratch theta differs")
            found[(backend, frac)] = dict(
                stop=st.refresh_stop, repeeled=rep, total=total,
                sweeps=st.rho_fd, wall=wall, full_wall=full_wall)
            log(f"{pname}: k={len(ins)} inserts + {len(dels)} deletes, "
                f"theta == exact oracle | stop used {st.refresh_stop} "
                f"(first rung {stops[0]}, ladder of {len(stops)}) | "
                f"subsets re-peeled {rep} of {total} | sweeps {st.rho_fd} "
                f"wedges {st.wedges_fd} | loop calls "
                f"{st.device_loop_calls} host round trips "
                f"{st.host_round_trips} | wall {wall:.3f} s (supports + "
                f"repeel) vs from-scratch decompose {full_wall:.3f} s "
                f"(x{full_wall / wall:.2f}) | max_memory_allocated {peak} "
                f"(from scratch {full_peak}) | launches "
                + str({k: v for k, v in launches[pname].items() if v}))
            peel_key = ("butterfly_update_sparse[peel]"
                        if backend == "cuda_sparse" else
                        "butterfly_update[peel]")
            count_key = peel_key.replace("[peel]", "[count]")
            for key in (peel_key, count_key):
                if launches[pname][key] <= 0:
                    raise AssertionError(f"{pname}: {key} never launched")
        del base
    # phase 3's rows at refresh's shape: the median peel set (by rows) of
    # the recorded refresh, its matrix unsorted and column-compacted
    a, rows, valid = sorted(calls, key=lambda c: int(c[2].sum()))[
        len(calls) // 2]
    s = valid.float()
    b = a[rows.long()] * s[:, None]
    ids = torch.arange(a.shape[0], dtype=torch.int32, device=dev)
    blocks = (128, 128, 512)
    row_ext = bsp.row_extents_device(a, blocks[2])
    kmax = bsp.tile_extents(row_ext, blocks[0]).to(torch.int32)
    kb = bsp.gathered_tile_extents(row_ext, rows, valid, blocks[1])
    ops1, bytes1, live1 = peel_live_work(torch, a, b, s)
    log(f"butterfly_update[peel_refresh]: matrix {tuple(a.shape)} "
        f"(unsorted, compacted), {len(calls)} sweeps recorded, median "
        f"{int(valid.sum())} valid of {len(rows)} gathered rows, "
        f"{live1:.0f} of {a.shape[1]} columns live")
    measure("butterfly_update[peel_refresh]",
            lambda: bfly.butterfly_update(a, b, s, ids, rows),
            lambda: bfly.butterfly_update_plain(a, b, s, ids, rows),
            lambda: torch.matmul(a, b.T), ops1, bytes1, reps=50)
    ops4, bytes4, _ = peel_live_work(torch, a, b, s, kmax, kb, blocks)
    measure("butterfly_update_sparse[peel_refresh]",
            lambda: bsp.butterfly_update_sparse(a, b, s, ids, rows, kmax, kb,
                                                blocks=blocks),
            lambda: bsp.butterfly_update_sparse_plain(
                a, b, s, ids, rows, kmax, kb, blocks=blocks),
            lambda: torch.matmul(a, b.T), ops4, bytes4, reps=50)
    del calls, a, b
    return found


def wing_phase(torch, np, dev, g_full, launches, oracles, EngineConfig,
               Executor, ops, sp_mid, mutation):
    """Phase 5d: the edge axis on sp_mid, P = 8 (``EngineConfig``'s
    default), ``cuda_sparse``, both CD dispatches, side U: psi held to the
    exact host oracle (from the worker pool), the admission estimate to
    the peak, one dispatch profiled; the closed form timed at the
    full-size graph's wing matrix and at sp_mid's FD stack; then
    ``Executor.repeel`` of the wing at 1% mutations against the oracle of
    the mutated graph.  The edge path launches no hand kernel (the closed
    form is two float64 matrix products): every launch count must stay
    0.  Returns the timed rows of the closed form and the wing refresh's
    stop, subsets and sweeps."""
    from repro_torch.core.engine.wing import build_edge_state
    from repro_torch.service.refresh import _mark_subsets

    psi_want, max_sup, max_m3 = oracles[("wing", 0.0)].result()
    log(f"wing: sp_mid {sp_mid.n_u} x {sp_mid.n_v}, {sp_mid.m} edges; exact "
        f"oracle: max psi {int(psi_want.max())}, max support {max_sup}, "
        f"max closed-form entry {max_m3}")
    if max(max_sup, max_m3) >= EXACT_LIMIT:
        raise AssertionError("a wing support or closed-form entry is past "
                             "2^24")
    stats_of = {}
    for dispatch in ("subset", "graph"):
        pname = f"wing_{dispatch}"
        ex = Executor(EngineConfig(workload="wing", backend="cuda_sparse",
                                   cd_dispatch=dispatch))
        plan = ex.plan(sp_mid)
        wd, wall, peak, resident = counted(
            torch, ops, launches, pname,
            lambda: ex.decompose(sp_mid, plan=plan))
        if not np.array_equal(wd.edge_wing, psi_want):
            raise AssertionError(f"{pname}: psi differs from the exact "
                                 "oracle")
        if any(launches[pname].values()):
            raise AssertionError(f"{pname}: launched {launches[pname]}")
        st = wd.stats
        stats_of[dispatch] = st
        log(f"{pname}: psi == exact oracle | wall {wall:.3f} s (time_count "
            f"{st.time_count:.3f} time_cd {st.time_cd:.3f} time_fd "
            f"{st.time_fd:.3f}) | rho_cd {st.rho_cd} rho_fd {st.rho_fd} "
            f"huc_recounts {st.huc_recounts} elided {st.elided_sweeps} "
            f"wedges_cd {st.wedges_cd} wedges_fd {st.wedges_fd} "
            f"subsets {st.num_subsets} fd_max_levels {st.fd_max_levels} | "
            f"host_round_trips {st.host_round_trips} | "
            f"max_memory_allocated {peak}")
        check_admission(pname, plan.padded_bytes, peak - resident)
        if dispatch == "graph":
            where_the_time_goes(torch, lambda: ex.decompose(sp_mid,
                                                            plan=plan))

    # the closed form at the full graph's wing matrix and sp_mid's FD
    # stack (the (8, R, C) stack of subsets >= s of the graph run)
    rows = {}
    es = build_edge_state(g_full, EngineConfig().to_receipt_config(),
                          device=dev)
    st_g = stats_of["graph"]
    cuts = np.asarray(st_g.bounds)
    a_full, eu_f, ev_f = es["a"], es["eu"], es["ev"]
    rows["edge_support_all[full]"] = (a_full, eu_f, ev_f, g_full)
    member = np.searchsorted(cuts[1:], psi_want, side="right")
    stack = np.zeros((len(cuts) - 1, 4096, 4096), np.float32)
    for k in range(stack.shape[0]):
        keep = member >= k
        stack[k, sp_mid.edges_u[keep], sp_mid.edges_v[keep]] = 1.0
    eu_s = torch.as_tensor(sp_mid.edges_u, device=dev).long()
    ev_s = torch.as_tensor(sp_mid.edges_v, device=dev).long()
    rows["edge_support_all[sp_mid_fd]"] = (torch.from_numpy(stack).to(dev),
                                           eu_s, ev_s, None)
    del stack, es
    out = {}
    for key, (a, eu, ev, g_host) in rows.items():
        got = ops.edge_support_all(a, eu, ev)
        # held to an int64 host count (scipy sparse), member by member
        mats = [a] if a.dim() == 2 else list(a)
        for k, m in enumerate(mats):
            want = sparse_edge_supports(np, m, eu, ev)
            if not np.array_equal(got[k].cpu().numpy() if a.dim() == 3
                                  else got.cpu().numpy(), want):
                raise AssertionError(f"{key}: differs from the int64 count")
        r, c = a.shape[-2:]
        g_n = a.shape[0] if a.dim() == 3 else 1
        flop = 4.0 * g_n * r * c * c
        nbytes = 4.0 * a.numel() + 16.0 * eu.numel() + 4.0 * got.numel()
        b_ms = max(flop / FP64_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        ms = time_ms(torch, lambda: ops.edge_support_all(a, eu, ev), 3)
        out[key] = dict(ms=ms, bound_ms=b_ms, bound_by=(
            "operations" if flop / FP64_FLOP_PER_S
            >= nbytes / HBM_BYTES_PER_S else "bytes"),
            shape=tuple(a.shape), flop=flop)
        log(f"{key}: {tuple(a.shape)}, {eu.numel()} slots: equal to the "
            f"int64 count | ms={ms:.3f} bound_ms={b_ms:.3f} "
            f"({out[key]['bound_by']}: {flop:.4e} float64 tensor-core flop "
            f"at {FP64_FLOP_PER_S / 1e12:.0f} TFLOP/s) | "
            f"{flop / ms / 1e9:.1f} TFLOP/s achieved; not a kernel (two "
            "torch.matmul in float64), recorded beside the kernel table")
        del got
    del rows, a_full

    # the wing refresh: 1% of sp_mid's edges mutated
    g1, ins, dels = mutation
    ex = Executor(EngineConfig(workload="wing", backend="cuda_sparse",
                               cd_dispatch="graph"))
    pname = f"refresh_wing_{WING_REFRESH_FRAC}"

    def run():
        sup, psi_old, stops, watch = wing_refresh_inputs(
            torch, np, ops, dev, sp_mid, g1, ins, dels, psi_want,
            st_g.bounds)
        return ex.repeel(g1, sup0=sup, numbers_old=psi_old, stops=stops,
                         watch=watch), stops

    ((psi, st), stops), wall, peak, _ = counted(torch, ops, launches, pname,
                                                run)
    psi1 = oracles[("wing", WING_REFRESH_FRAC)].result()[0]
    if not np.array_equal(psi, psi1):
        raise AssertionError(f"{pname}: psi differs from the exact oracle "
                             "of the mutated graph")
    _mark_subsets(st, st_g.bounds)
    rep, total = st.refresh_subsets_repeeled, st.refresh_subsets_total
    log(f"{pname}: k={len(ins)} inserts + {len(dels)} deletes, psi == exact "
        f"oracle | stop used {st.refresh_stop} (first rung {stops[0]}) | "
        f"subsets re-peeled {rep} of {total} | sweeps {st.rho_fd} | "
        f"host round trips {st.host_round_trips} | wall {wall:.3f} s "
        f"(supports + repeel) | max_memory_allocated {peak}")
    return out, dict(stop=st.refresh_stop, repeeled=rep, total=total,
                     sweeps=st.rho_fd, wall=wall)


def service_phase(torch, np, dev, g_full, want, sp_mid, fleet, want_fleet,
                  launches, oracles, mutations, wing_mutation, refresh_rows,
                  wing_refresh, EngineConfig, BipartiteGraph, ops):
    """Phase 5e: the decomposition service (``repro_torch.service``) on
    the card, each arm logged on its own line.

    1. tip, inline, full size: per rung of ``REFRESH_FRACS``, ingest
       (``replace=True``) and flush (a full decompose, its estimate held
       to its peak), phase 5c's inserts and deletes, then a timed flush:
       theta equal to the mutated graph's oracle on the delta path, the
       stop, the subsets re-peeled and the sweeps equal to phase 5c's
       ``refresh_cuda_{frac}``;
    2. tip, background: a read right after the 1% mutation returns the
       old version without blocking, then the drained read is fresh and
       exact, and ``close()`` joins the worker;
    3. the fleet: phase 5b's 128 cold graphs in one flush (one
       ``Executor.map`` fleet), then 16 members mutated at 2% and
       refreshed on the delta path, each equal to its host oracle;
    4. a cache budget below one result (an eviction, then an exact
       recompute) and ``refresh_worker@2`` with the worker on (a counted
       crash and restart, exact numbers), on fleet members;
    5. wing on sp_mid with phase 5d's 1% mutation: psi equal to the
       oracle on the delta path, stop and sweeps equal to phase 5d's;
    6. ``repro_torch.launch.serve.main`` with the reference's CI lines
       (two selftests, the background soak, the soak under
       ``RECEIPT_FAULT=refresh_worker@2``), each returning 0.
    """
    import os

    from repro_torch.api import faults
    from repro_torch.launch import serve
    from repro_torch.service import (DatasetState, DecompositionService,
                                     ServiceConfig, classify_refresh)

    threshold = 0.12

    # ---- arm 1: tip, inline, full size ----
    svc = DecompositionService(
        EngineConfig(num_partitions=FULL["partitions"]),
        ServiceConfig(refresh_dirty_threshold=threshold))
    if svc.device.type != "cuda":
        raise AssertionError("DecompositionService() must run on the card")
    walls = {}
    for frac in REFRESH_FRACS:
        g1, ins, dels = mutations[frac]
        pname = f"service_tip_{frac}"

        def full():
            svc.ingest("marvel", g_full, replace=True)
            return svc.flush()

        rep, full_wall, peak, resident = counted(
            torch, ops, launches, f"{pname}_full", full)
        dec = svc.query("marvel")
        if rep["full"] != 1 or not np.array_equal(dec.numbers, want):
            raise AssertionError(f"{pname}_full: {rep}, or theta differs "
                                 "from the exact oracle")
        check_admission(f"{pname}_full", dec.plan.padded_bytes,
                        peak - resident)
        svc.insert_edges("marvel", ins[:, 0], ins[:, 1])
        svc.delete_edges("marvel", dels[:, 0], dels[:, 1])
        rep, wall, peak, _ = counted(torch, ops, launches, pname, svc.flush)
        dec = svc.query("marvel")
        st = dec.stats
        if rep["refreshed"] != 1 or st.refresh_mode != "delta":
            raise AssertionError(f"{pname}: not a delta refresh: {rep}")
        if not np.array_equal(dec.numbers,
                              oracles[("tip", frac)].result()[0]):
            raise AssertionError(f"{pname}: theta differs from the exact "
                                 "oracle of the mutated graph")
        row = refresh_rows[("cuda", frac)]
        got = dict(stop=st.refresh_stop, repeeled=st.refresh_subsets_repeeled,
                   total=st.refresh_subsets_total, sweeps=st.rho_fd)
        if any(got[k] != row[k] for k in got):
            raise AssertionError(f"{pname}: {got} differs from phase 5c's "
                                 f"refresh_cuda_{frac} {row}")
        walls[frac] = wall
        log(f"{pname}: delta refresh, theta == exact oracle | stop "
            f"{st.refresh_stop} subsets re-peeled "
            f"{st.refresh_subsets_repeeled} of {st.refresh_subsets_total} "
            f"sweeps {st.rho_fd} (phase 5c's refresh_cuda_{frac} the same) "
            f"| dirty edges {st.refresh_dirty_edges} t_hi {st.refresh_t_hi} "
            f"| host round trips {st.host_round_trips} | refresh flush wall "
            f"{wall:.3f} s vs the full flush {full_wall:.3f} s and phase "
            f"5c's from-scratch decompose of the mutated graph "
            f"{row['full_wall']:.3f} s (Executor.repeel there "
            f"{row['wall']:.3f} s) | max_memory_allocated {peak} | launches "
            + str({k: v for k, v in launches[pname].items() if v}))
    del svc

    # ---- arm 2: tip, background worker, full size ----
    g1, ins, dels = mutations[REFRESH_FRACS[0]]
    bg = DecompositionService(
        EngineConfig(num_partitions=FULL["partitions"]),
        ServiceConfig(refresh_dirty_threshold=threshold, background=True))
    try:
        bg.ingest("marvel", g_full)
        first = bg.query("marvel", wait=True, timeout=600)
        if not np.array_equal(first.numbers, want):
            raise AssertionError("service_background: base theta differs")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with bg._lock:                   # one mutation batch, atomically
            bg.insert_edges("marvel", ins[:, 0], ins[:, 1])
            bg.delete_edges("marvel", dels[:, 0], dels[:, 1])
        t0 = time.perf_counter()
        dec, info = bg.query("marvel", with_info=True)
        stale_s = time.perf_counter() - t0
        if info["fresh"] or dec is not first:
            raise AssertionError(f"service_background: the read right after "
                                 f"the mutation was not the old version: "
                                 f"{info}")
        t0 = time.perf_counter()
        if not bg.wait_until_idle(timeout=600):
            raise AssertionError("service_background: the worker did not "
                                 "drain")
        drain_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches["service_background"] = ops.launch_counts()
        dec, info2 = bg.query("marvel", with_info=True)
        if not (info2["fresh"] and dec.stats.refresh_mode == "delta"
                and np.array_equal(dec.numbers,
                                   oracles[("tip", REFRESH_FRACS[0])]
                                   .result()[0])):
            raise AssertionError(f"service_background: the fresh read is not "
                                 f"the exact delta refresh: {info2}")
        w = bg.report()["worker"]
        # what a drain cycle's route classification costs at this size
        # (the scheduler runs it off the service lock)
        probe = DatasetState(name="probe", workload="tip", version=3,
                             graph=bg._datasets["marvel"].graph,
                             base_graph=first.graph, result=first,
                             result_version=1)
        t0 = time.perf_counter()
        route = classify_refresh(probe, bg.service_config)
        classify_ms = (time.perf_counter() - t0) * 1e3
    finally:
        bg.close()
    if bg.worker._thread.is_alive():
        raise AssertionError("service_background: close() left the worker "
                             "thread running")
    log(f"service_background: stale read {stale_s * 1e3:.3f} ms (version "
        f"{info['result_version']} of {info['version']}, stale_by "
        f"{info['stale_by']}) while the worker refreshed; wait_until_idle "
        f"{drain_s:.3f} s, arm 1's 1% refresh flush {walls[REFRESH_FRACS[0]]:.3f}"
        f" s; fresh read theta == exact oracle | a cycle's route "
        f"classification ({route}) {classify_ms:.3f} ms on the host, off "
        f"the service lock | worker cycles "
        f"{w['cycles']} crashes {w['crashes']} | launches "
        + str({k: v for k, v in launches["service_background"].items()
               if v}))

    # ---- arm 3: the fleet through one Executor.map, then 16 refreshes ----
    fl = DecompositionService(EngineConfig(), ServiceConfig(
        refresh_dirty_threshold=threshold))
    for k, g in enumerate(fleet):
        fl.ingest(f"m{k}", g)
    rep, wall, peak, _ = counted(torch, ops, launches, "service_fleet",
                                 fl.flush)
    bad = [k for k in range(len(fleet))
           if not np.array_equal(fl.query(f"m{k}").numbers, want_fleet[k])]
    if rep["fleets"] != 1 or rep["mapped"] != len(fleet) or bad:
        raise AssertionError(f"service_fleet: {rep}; members {bad[:8]} "
                             "differ from phase 5b's")
    log(f"service_fleet: {len(fleet)} ingests, one flush: fleets "
        f"{rep['fleets']} mapped {rep['mapped']}, every member == phase 5b's "
        f"map result (held to the exact oracle there) | wall {wall:.3f} s | "
        f"max_memory_allocated {peak} | launches "
        + str({k: v for k, v in launches["service_fleet"].items() if v}))
    t0 = time.perf_counter()
    want_mut = {}
    for k in range(16):
        g1k, insk, delsk = mutate(np, BipartiteGraph, fleet[k], 0.02,
                                  seed=1000 + k)
        fl.insert_edges(f"m{k}", insk[:, 0], insk[:, 1])
        fl.delete_edges(f"m{k}", delsk[:, 0], delsk[:, 1])
        want_mut[k] = exact_theta(g1k)[0]
    oracle_s = time.perf_counter() - t0
    rep, wall, peak, _ = counted(torch, ops, launches,
                                 "service_fleet_refresh", fl.flush)
    modes = {k: fl.query(f"m{k}").stats.refresh_mode for k in want_mut}
    bad = [k for k in want_mut
           if not np.array_equal(fl.query(f"m{k}").numbers, want_mut[k])]
    if (rep["refreshed"] != 16 or rep["repeel_fleets"] < 1 or bad
            or set(modes.values()) != {"delta"}):
        raise AssertionError(f"service_fleet_refresh: {rep}, modes {modes}, "
                             f"members {bad} differ from their oracles")
    log(f"service_fleet_refresh: 16 members mutated at 2% (host oracles "
        f"{oracle_s:.2f} s), one flush: refreshed {rep['refreshed']} "
        f"repeel_fleets {rep['repeel_fleets']}, every member delta and == "
        f"its exact oracle | wall {wall:.3f} s | launches "
        + str({k: v for k, v in launches["service_fleet_refresh"].items()
               if v}))
    del fl

    # ---- arm 4: the cache governor, then crash isolation ----
    gov = DecompositionService(EngineConfig(), ServiceConfig(
        cache_budget_bytes=64))
    gov.ingest("a", fleet[0])
    gov.ingest("b", fleet[1])
    gov.query("a")
    gov.query("b")                       # evicts a: the budget < a result
    cache = gov.cache_report()
    if cache["evicted_total"] < 1 or gov._datasets["a"].result is not None:
        raise AssertionError(f"service_governor: no eviction: {cache}")
    dec = gov.query("a")                 # recompute on demand
    ds = gov._datasets["a"]
    if not (np.array_equal(dec.numbers, want_fleet[0])
            and ds.evictions >= 1 and ds.full_recomputes >= 2):
        raise AssertionError("service_governor: the evicted dataset did not "
                             "recompute exactly")
    log(f"service_governor: budget 64 bytes: evicted_total "
        f"{gov.cache_report()['evicted_total']}, the evicted dataset "
        f"recomputed (full_recomputes {ds.full_recomputes}), theta == exact "
        "oracle")
    g1c, insc, delsc = mutate(np, BipartiteGraph, fleet[2], 0.02, seed=2000)
    crash = DecompositionService(
        EngineConfig(fault_spec="refresh_worker@2"),
        ServiceConfig(refresh_dirty_threshold=threshold, background=True,
                      worker_poll_s=0.01, worker_backoff_s=0.0))
    try:
        crash.ingest("c", fleet[2])
        crash.query("c", wait=True, timeout=300)
        with crash._lock:
            crash.insert_edges("c", insc[:, 0], insc[:, 1])
            crash.delete_edges("c", delsc[:, 0], delsc[:, 1])
        dec = crash.query("c", wait=True, timeout=300)
        w = crash.report()["worker"]
    finally:
        crash.close()
    if not (w["crashes"] >= 1 and w["restarts"] >= 1 and w["failure_log"]
            and np.array_equal(dec.numbers, exact_theta(g1c)[0])):
        raise AssertionError(f"service_crash: {w}, or theta differs")
    log(f"service_crash: refresh_worker@2: crashes {w['crashes']} restarts "
        f"{w['restarts']} dead {w['dead']} failure log "
        f"{[e['type'] for e in w['failure_log']]}; refresh "
        f"{dec.stats.refresh_mode}, theta == exact oracle")

    # ---- arm 5: wing on sp_mid ----
    wsvc = DecompositionService(
        EngineConfig(backend="cuda_sparse", cd_dispatch="graph"),
        ServiceConfig(refresh_dirty_threshold=threshold))
    wsvc.ingest("sp_mid", sp_mid, workload="wing")
    rep, full_wall, peak, resident = counted(
        torch, ops, launches, "service_wing_full", wsvc.flush)
    dec = wsvc.query("sp_mid")
    if not np.array_equal(dec.numbers, oracles[("wing", 0.0)].result()[0]):
        raise AssertionError("service_wing_full: psi differs")
    check_admission("service_wing_full", dec.plan.padded_bytes,
                    peak - resident)
    g1w, insw, delsw = wing_mutation
    wsvc.insert_edges("sp_mid", insw[:, 0], insw[:, 1])
    wsvc.delete_edges("sp_mid", delsw[:, 0], delsw[:, 1])
    pname = f"service_wing_{WING_REFRESH_FRAC}"
    rep, wall, peak, _ = counted(torch, ops, launches, pname, wsvc.flush)
    dec = wsvc.query("sp_mid")
    st = dec.stats
    got = dict(stop=st.refresh_stop, repeeled=st.refresh_subsets_repeeled,
               total=st.refresh_subsets_total, sweeps=st.rho_fd)
    if (st.refresh_mode != "delta" or any(got[k] != wing_refresh[k]
                                          for k in got)
            or not np.array_equal(
                dec.numbers,
                oracles[("wing", WING_REFRESH_FRAC)].result()[0])):
        raise AssertionError(f"{pname}: {st.refresh_mode} {got} against "
                             f"phase 5d's {wing_refresh}, or psi differs")
    log(f"{pname}: delta refresh, psi == exact oracle | stop "
        f"{st.refresh_stop} subsets re-peeled {got['repeeled']} of "
        f"{got['total']} sweeps {st.rho_fd} (phase 5d's the same) | host "
        f"round trips {st.host_round_trips} | refresh flush wall {wall:.3f} s"
        f" vs the full flush {full_wall:.3f} s | max_memory_allocated "
        f"{peak}")
    del wsvc

    # ---- arm 6: the CLI, the reference's CI lines ----
    soak = ["--soak", "--background", "--datasets", "2", "--mutations", "2"]
    for argv, fault in ((["--selftest", "--workload", "tip"], None),
                        (["--selftest", "--workload", "wing"], None),
                        (soak, None), (soak, "refresh_worker@2")):
        old = os.environ.pop(faults.ENV_VAR, None)
        if fault:
            os.environ[faults.ENV_VAR] = fault
        faults.reset()
        try:
            t0 = time.perf_counter()
            rc = serve.main(argv)
            cli_s = time.perf_counter() - t0
        finally:
            os.environ.pop(faults.ENV_VAR, None)
            if old is not None:
                os.environ[faults.ENV_VAR] = old
            faults.reset()
        line = " ".join(argv) + (f" with RECEIPT_FAULT={fault}" if fault
                                 else "")
        if rc != 0:
            raise AssertionError(f"service_cli: {line} returned {rc}")
        log(f"service_cli: python -m repro_torch.launch.serve {line}: "
            f"returned 0 in {cli_s:.2f} s")


def mesh_phase(torch, np, dev, g_full, want, launches, full_stats,
               full_walls, paths, EngineConfig, Executor, DeviceGraph, ops):
    """Phase 5f: the distributed engine (``repro_torch.core.distributed``)
    on the card, a (2, 2) ``("data", "model")`` mesh whose four shards all
    sit on this one card.

    1. ``Executor(EngineConfig(num_partitions=150), mesh=mesh).decompose``
       on the full-size graph, on ``cuda``, then on ``cuda_sparse`` with
       the graph dispatch: theta equal to the oracle, ``rho_fd`` and
       ``wedges_fd`` equal to phase 5's single-device run of the same
       config, ``fd_shards == 4``, work on more than one shard, the shard
       wedges within ``wedges_fd``, each shape group's LPT loads within
       the list-scheduling bound (total / shards + the heaviest task),
       kernels 2 (5) and 3 launched, no f32 tile body, and the peak
       within the plan's estimate;
    2. the sharded CD entry points on the engine's sorted (8192, 8192)
       matrix, on a (4, 1) and a (2, 2) mesh: the count with every real
       row alive against kernel 1's count body, one sweep of a 256-row
       peel set (both ``impl``s) against kernel 1's peel form, and the
       range loop over the first CD range of the P = 150 run against a
       single-device emulation with kernel 1: ``torch.equal``, each
       call's time logged.
    """
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
    log(f"mesh: {dict(mesh.shape)} over {len(mesh.devices)} shards, all on "
        f"{dev} ({torch.cuda.get_device_name(0)}): the 4 shards share one "
        "card and run one after another")

    # ---- 1. the mesh decomposes ----
    lpt = []
    shard_level_group = dist.shard_level_group

    def recording(built, n_shards, init_loads=None):
        arr, slots = shard_level_group(built, n_shards, init_loads)
        lpt.append(([t["wedges"] for t in built["group"]],
                    arr["shard_load"]))
        return arr, slots

    runs = (("mesh_dense", "dense_subset",
             EngineConfig(num_partitions=FULL["partitions"])),
            ("mesh_sparse", "sparse_graph",
             EngineConfig(num_partitions=FULL["partitions"],
                          backend="cuda_sparse", cd_dispatch="graph")))
    must = {"mesh_dense": ("butterfly_update_batched[peel]",
                           "b2_stack[pairs]"),
            "mesh_sparse": ("butterfly_update_sparse_batched[peel]",
                            "b2_stack[pairs]")}
    dist.shard_level_group = recording
    try:
        for pname, single, cfg in runs:
            ex = Executor(cfg, mesh=mesh)
            plan = ex.plan(g_full)
            if plan.mesh_shards != 4 or plan.representation != "dense":
                raise AssertionError(f"{pname}: plan {plan.mesh_shards} "
                                     f"shards, {plan.representation}")
            lpt.clear()
            td, wall, peak, resident = counted(
                torch, ops, launches, pname,
                lambda: ex.decompose(g_full, plan=plan))
            st, one = td.stats, full_stats[single]
            if not np.array_equal(td.theta, want):
                raise AssertionError(f"{pname}: theta differs from the "
                                     "exact oracle")
            if (st.rho_fd, st.wedges_fd) != (one.rho_fd, one.wedges_fd):
                raise AssertionError(
                    f"{pname}: rho_fd / wedges_fd {st.rho_fd} / "
                    f"{st.wedges_fd} differ from {single}'s {one.rho_fd} / "
                    f"{one.wedges_fd}")
            busy = sum(1 for r in st.fd_shard_rho if r > 0)
            if (st.fd_shards != 4 or busy < 2
                    or sum(st.fd_shard_wedges) > st.wedges_fd):
                raise AssertionError(
                    f"{pname}: fd_shards {st.fd_shards}, shard rho "
                    f"{st.fd_shard_rho}, shard wedges {st.fd_shard_wedges} "
                    f"against wedges_fd {st.wedges_fd}")
            weights = [w for ws, _ in lpt for w in ws]
            loads = np.sum([ld for _, ld in lpt], axis=0)
            lpt_bound = sum(weights) / mesh.size + max(weights)
            if loads.max() > lpt_bound:
                raise AssertionError(f"{pname}: shard loads {loads} past "
                                     f"the LPT bound {lpt_bound}")
            idle = [k for k in must[pname] if launches[pname][k] <= 0]
            tile = [k for k, n in launches[pname].items()
                    if (k.endswith("[tile]")
                        or k == "butterfly_update_tiled[count]") and n]
            if idle or tile:
                raise AssertionError(f"{pname}: never launched {idle}, "
                                     f"launched {tile}")
            log(f"{pname}: theta == exact oracle | wall {wall:.3f} s "
                f"({single} {full_walls[single]:.3f} s) | time_cd "
                f"{st.time_cd:.3f} time_fd {st.time_fd:.3f} s ({single} "
                f"{one.time_fd:.3f}) | host_round_trips "
                f"{st.host_round_trips} ({single} {one.host_round_trips}) | "
                f"rho_fd {st.rho_fd} wedges_fd {st.wedges_fd} (== "
                f"{single}) | fd_groups {st.fd_groups} fd_shards "
                f"{st.fd_shards} fd_shard_rho {st.fd_shard_rho} "
                f"fd_shard_wedges {st.fd_shard_wedges} fd_padding_waste "
                f"{st.fd_padding_waste:.4f} device_loop_calls "
                f"{st.device_loop_calls}")
            log(f"{pname}: LPT static loads per shard {loads.tolist()} "
                f"(bound {lpt_bound:.1f}, {len(weights)} tasks in "
                f"{len(lpt)} groups) | launches "
                + str({k: v for k, v in launches[pname].items() if v}))
            check_admission(pname, plan.padded_bytes, peak - resident)
            where_the_time_goes(torch, lambda: ex.decompose(g_full,
                                                            plan=plan),
                                top=5)
    finally:
        dist.shard_level_group = shard_level_group

    # ---- 2. the sharded CD entry points at full size ----
    dg = DeviceGraph(g_full.relabel_by_degree(), np.arange(g_full.n_u),
                     paths["sparse_graph"], device=dev)
    a = dg.a
    n_a = a.shape[0]
    ids = torch.arange(n_a, dtype=torch.int32, device=dev)
    alive = torch.arange(n_a, device=dev) < dg.n_rows
    s = alive.float()
    sup0 = ops.butterfly_support(a, s)
    rng = np.random.default_rng(5)
    n_peel, width = 240, 256
    rows_np = np.zeros(width, np.int64)
    rows_np[:n_peel] = np.sort(rng.choice(dg.n_rows, n_peel, replace=False))
    rows = torch.as_tensor(rows_np, dtype=torch.int32, device=dev)
    valid = (torch.arange(width, device=dev) < n_peel).float()

    def sweep_one(sup, alv, rows, valid, lo):
        """One sweep on one device: kernel 1's peel form, then the
        reference's update rule."""
        delta = ops.butterfly_update(a, a[rows.long()] * valid[:, None],
                                     valid, ids, rows)
        peeled = torch.zeros(n_a, dtype=torch.bool, device=dev)
        peeled[rows.long()[valid > 0.5]] = True
        alv2 = alv & ~peeled
        return torch.where(alv2, (sup - delta).clamp(min=lo), sup), alv2

    want_sweep = sweep_one(sup0, alive, rows, valid, 0.0)

    def range_loop(hi):
        """The range loop on one device, sweep by sweep with kernel 1."""
        sup, alv, rho = sup0, alive, 0
        while True:
            peel = alv & (sup < hi)
            n = int(peel.sum())
            if n == 0:
                return sup, alv, rho
            r = torch.nonzero(peel).flatten().to(torch.int32)
            sup, alv = sweep_one(sup, alv, r, torch.ones(n, device=dev), 0.0)
            rho += 1

    # the first CD range of the P = 150 run, and a wider one (below the
    # support of the real rows' first quartile) that takes several sweeps
    ranges = {"first": float(full_stats["dense_subset"].bounds[1]),
              "quartile": float(sup0[alive].quantile(0.25))}
    want_loop = {k: range_loop(hi) for k, hi in ranges.items()}
    log(f"mesh CD: sorted matrix {tuple(a.shape)}, {dg.n_rows} real rows; "
        + "; ".join(f"range {k} [0, {hi:.0f}): "
                    f"{int((alive & (sup0 < hi)).sum())} rows below hi, "
                    f"{want_loop[k][2]} sweeps" for k, hi in ranges.items()))
    for shape in ((4, 1), (2, 2)):
        m = make_mesh(shape, ("data", "model"), devices=[dev] * 4)
        tag = f"mesh_cd_{shape[0]}x{shape[1]}"
        times = {}
        got, times["count"], _, _ = counted(
            torch, ops, launches, tag + "_count",
            lambda: dist.distributed_butterfly_support(m, a, s))
        if not torch.equal(got, sup0):
            raise AssertionError(f"{tag}: the count differs from kernel "
                                 "1's count body")
        for impl in ("gspmd", "shardmap"):
            (gs, ga), times[impl], _, _ = counted(
                torch, ops, launches, f"{tag}_{impl}",
                lambda: dist.distributed_cd_sweep(
                    m, a, sup0, alive, rows, valid, 0.0, impl=impl))
            if not (torch.equal(gs, want_sweep[0])
                    and torch.equal(ga, want_sweep[1])):
                raise AssertionError(f"{tag} {impl}: the sweep differs "
                                     "from kernel 1's peel form")
        rhos = {}
        for k, hi in ranges.items():
            (ls, la, rhos[k], ovf), times[f"loop_{k}"], _, _ = counted(
                torch, ops, launches, f"{tag}_loop_{k}",
                lambda: dist.distributed_cd_fused_loop(
                    m, a, sup0, alive, hi, 0.0, peel_width=n_a))
            want_s, want_a, want_rho = want_loop[k]
            if ovf or rhos[k] != want_rho or not (
                    torch.equal(ls, want_s) and torch.equal(la, want_a)):
                raise AssertionError(
                    f"{tag}: the range loop over {k} differs from the "
                    f"emulation (rho {rhos[k]} vs {want_rho}, overflow "
                    f"{ovf})")
        peel1 = sum(n[1]["butterfly_update[peel]"] for n in launches.items()
                    if n[0].startswith(tag + "_"))
        if (shape[1] == 1) != (peel1 > 0):
            raise AssertionError(f"{tag}: kernel 1's peel body launched "
                                 f"{peel1} times")
        log(f"{tag}: torch.equal (count, sweep gspmd + shardmap, range "
            f"loops {rhos} sweeps) | s: "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
            + f" | kernel 1 peel launches {peel1}")
    del dg, a, sup0


def recsys_phase(torch, np, dev, launches, ops, bfly, bsp, measure):
    """Phase 5g: the training substrate and the recsys path on the card.

    1. tip filtering: the recsys example's 12 cohorts (200 x 150, 8 spam
       users on 12 items each) through ``Executor.map`` on the card, every
       member's theta equal to ``exact_theta``, the map's kernels
       launched (the counting form of kernel 2, kernel 3's b2 form), the
       example's recall and precision lines; then each of the two kernels
       held ``torch.equal`` to its plain version and timed (``measure``)
       on the very inputs the map handed it (its first call's arguments,
       cloned during the run);
    2. full width: ``get_bundle("two-tower-retrieval", reduced=False)``
       (the published widths: 16,652,048 table rows of 256 floats) on the
       card, 5 train steps at batch RECSYS_BATCH from ``recsys_batch``
       seeds 0-4: finite losses, each step's ms (CUDA events), the peak
       against 4 x the parameter bytes (at most 4 P + 2 GB above what was
       resident), and after step 1 RECSYS_DECAY_ROWS sampled untouched
       rows of every table moved by weight decay alone (1 ulp);
    3. checkpoint and restart at the reduced config: ``train_loop`` with a
       checkpoint every 2 steps for 4 steps, then resumed (start step 4),
       every restored leaf ``torch.equal`` to the saved one;
    4. card against CPU: 3 reduced steps of ``make_train_step`` on the
       card and on the CPU from the same params and batches, within the
       CPU tests' tolerance (rtol 1e-5, atol 1e-7; TF32 is off).
    """
    import copy
    import importlib.util
    import tempfile

    from repro_torch.configs import get_bundle
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.launch.train import train_loop
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_step import init_train_state
    from repro_torch.train.tree import keystr, leaves_with_paths

    arch = "two-tower-retrieval"
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"recsys: mem_get_info free {free} of {total} bytes, "
        f"memory_allocated {torch.cuda.memory_allocated()} bytes")

    # ---- 1. tip filtering of the cohort fleet ----
    root = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "recsys_tip_filtering_torch",
        root / "examples" / "recsys_tip_filtering_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cohorts, spam_sets = example.build_fleet(12)
    want = [exact_theta(g)[0] for g in cohorts]
    seen, restore = first_calls(torch, [(bfly, "butterfly_update_batched"),
                                        (bsp, "b2_stack")])
    tds, wall, peak, _ = counted(
        torch, ops, launches, "recsys_map",
        lambda: example.decompose_fleet(cohorts, device=dev))
    restore()
    bad = [k for k, (td, w) in enumerate(zip(tds, want))
           if not np.array_equal(td.theta, w)]
    if bad:
        raise AssertionError(f"recsys_map: theta differs from the exact "
                             f"oracle on cohorts {bad}")
    ran = {k: v for k, v in launches["recsys_map"].items() if v}
    idle = [k for k in ("butterfly_update_batched[peel]", "b2_stack[pairs]")
            if not ran.get(k)]
    if idle:
        raise AssertionError(f"recsys_map: {idle} never launched ({ran})")
    tp, flagged, spam = example.flag_spam(tds, spam_sets)
    log(f"recsys_map: 12 cohorts, theta == exact oracle | wall {wall:.3f} s "
        f"| max_memory_allocated {peak} | launches {ran} | recall "
        f"{tp / spam:.3f} precision {tp / max(flagged, 1):.3f}")
    # kernel 2's counting form at the cohort chunk's own stack (A = B, the
    # members' rows alive, the padding groups' none); bound: the pairs of
    # each group's rows the counting form needs (count_pair_ops, per
    # group) or the stack read once, s and out, the ids
    (a, b, s_, ids_a, ids_b), _ = seen["butterfly_update_batched"]
    if not (torch.equal(a, b) and torch.equal(ids_a, ids_b)):
        raise AssertionError("recsys_map: the counting call's A != B")
    ops_c = sum(count_pair_ops(torch, a[k], s_[k])
                for k in range(a.shape[0]))
    log(f"recsys_map counting form: stack {tuple(a.shape)}, "
        f"{int((s_ != 0).sum())} live rows, {int(a.sum().item())} "
        f"nonzeros, {ops_c:.4g} operations")
    measure("butterfly_update_batched[recsys_count]",
            lambda: bfly.butterfly_update_batched(a, b, s_, ids_a, ids_b),
            lambda: bfly.butterfly_update_batched_plain(a, b, s_, ids_a,
                                                        ids_b),
            lambda: torch.bmm(a, a.transpose(1, 2)), ops_c,
            4.0 * (a.numel() + 2 * s_.numel() + ids_a.numel()), reps=10)
    # kernel 3's b2 form on the same stack and the extents ops.b2_stack
    # derived from it; bound: the distinct nonzero row pairs (b2_pair_ops)
    # or the stack read once and the (G, m, m) output written once
    (a2, ka, kb), kw = seen["b2_stack"]
    if not torch.equal(a2, a):
        raise AssertionError("recsys_map: b2_stack saw another stack than "
                             "the counting call")
    g_n, m_n = a2.shape[:2]
    measure("b2_stack[recsys_b2]",
            lambda: bsp.b2_stack(a2, ka, kb, **kw),
            lambda: bsp.b2_stack_plain(a2, ka, kb, **kw),
            lambda: torch.bmm(a2, a2.transpose(1, 2)),
            b2_pair_ops(torch, a2, ka, kb, kw["blocks"]),
            4.0 * (a2.numel() + g_n * m_n * m_n + ka.numel() + kb.numel()),
            reps=10)
    del seen, a, b, s_, ids_a, ids_b, a2, ka, kb

    # ---- 2. the full published widths, 5 steps ----
    bundle = get_bundle(arch, reduced=False)
    cfg = bundle.cfg
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(params, bundle.opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    rows = sum(t.shape[0] for t in (*params.user_tables,
                                    *params.item_tables))
    log(f"recsys full: {rows} table rows x {cfg.embed_dim}, parameter "
        f"bytes P = {p_bytes}, params + AdamW state on the card in "
        f"{init_s:.2f} s")
    step = bundle._steps["train"]
    tables = (*params.user_tables, *params.item_tables)
    rng = np.random.default_rng(0)
    ms, losses = [], []
    for s in range(5):
        batch = recsys_batch(cfg, RECSYS_BATCH, seed=s, device=dev)
        if s == 0:
            # sampled rows the batch does not touch, per table
            ids = ([batch["user_ids"][:, i]
                    for i in range(len(cfg.user_fields))]
                   + [batch["item_ids"][:, i]
                      for i in range(len(cfg.item_fields))])
            picks = []
            for t, used in zip(tables, ids):
                touched = np.unique(used.cpu().numpy())
                cand = np.setdiff1d(rng.integers(
                    0, t.shape[0], 4 * RECSYS_DECAY_ROWS), touched)
                if cand.size < RECSYS_DECAY_ROWS:
                    cand = np.setdiff1d(np.arange(t.shape[0]), touched)
                # a 1,024-row table is every row touched at this batch
                pick = torch.from_numpy(rng.choice(
                    cand, min(RECSYS_DECAY_ROWS, cand.size),
                    replace=False)).to(dev)
                picks.append((pick, t.detach()[pick].clone()))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        stop.record()
        torch.cuda.synchronize()
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"recsys full: step {s + 1} loss {loss}")
        losses.append(loss)
        ms.append(start.elapsed_time(stop))
        if s == 0:
            lr, wd = float(metrics["lr"]), bundle.opt_cfg.weight_decay
            moved = n = 0
            for (pick, old), t in zip(picks, tables):
                new = t.detach()[pick]
                want_p = old.double() * (1.0 - lr * wd)
                ulp = (torch.nextafter(new.abs(),
                                       torch.full_like(new, float("inf")))
                       - new.abs()).double()
                off = (new.double() - want_p).abs()
                if not bool((off <= ulp).all()):
                    raise AssertionError(
                        f"recsys full: an untouched row moved by more than "
                        f"weight decay (max {float((off / ulp).max()):.3f} "
                        "ulp)")
                moved += int((new != old).sum())
                n += new.numel()
            if moved <= n // 2:
                raise AssertionError(f"recsys full: weight decay moved only "
                                     f"{moved} of {n} untouched values")
            log(f"recsys full: after step 1, the sampled untouched rows "
                f"per table ({[int(p_.numel()) for p_, _ in picks]} of "
                f"{[t.shape[0] for t in tables]}) == p (1 - lr wd) within "
                f"1 ulp (lr {lr:.6e}, wd {wd}); {moved} of {n} values "
                "moved")
        del batch, metrics
    peak = torch.cuda.max_memory_allocated()
    limit = 4 * p_bytes + 2e9
    log(f"recsys full: batch {RECSYS_BATCH}, losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + " | step ms " + ", ".join(f"{x:.3f}" for x in ms)
        + f" (steps 2-5 mean {sum(ms[1:]) / 4:.3f})")
    log(f"recsys full: max_memory_allocated {peak} bytes ({peak - resident} "
        f"above the {resident} resident) | 4 x P = {4 * p_bytes} | limit "
        f"4 P + 2 GB = {int(limit)}")
    if peak - resident > limit:
        raise AssertionError(f"recsys full: peak {peak - resident} above "
                             f"4 P + 2 GB = {limit}")
    # the update's bytes: p, g, m, v read and p, m, v written, plus the
    # gradients' memset and the norm's read (HBM bound per step)
    log(f"recsys full: HBM bound of a step's update, memset and norm "
        f"(9 P over {HBM_BYTES_PER_S / 1e12} TB/s): "
        f"{9 * p_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    batch = recsys_batch(cfg, RECSYS_BATCH, seed=5, device=dev)
    where_the_time_goes(torch, lambda: step(state, batch), top=10)
    del state, params, tables, picks, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 3. checkpoint and restart at the reduced config ----
    with tempfile.TemporaryDirectory() as d:
        first = train_loop(arch=arch, steps=4, batch_size=64, ckpt_dir=d,
                           save_every=2, device=dev, log_every=0)
        again = train_loop(arch=arch, steps=2, batch_size=64, ckpt_dir=d,
                           save_every=2, device=dev, log_every=0)
        if again["start_step"] != 4:
            raise AssertionError(f"recsys restart: start step "
                                 f"{again['start_step']}, not 4")
        small = get_bundle(arch, reduced=True)
        back = CheckpointManager(d).restore(small.state_abstract(), step=4,
                                            device=dev)
        saved = leaves_with_paths(first["state"])
        got = leaves_with_paths(back)
        if [keystr(p_) for p_, _ in saved] != [keystr(p_) for p_, _ in got]:
            raise AssertionError("recsys restart: restored paths differ")
        diff = [keystr(p_) for (p_, a), (_, b) in zip(saved, got)
                if not (b.device.type == dev.type and torch.equal(a, b))]
        if diff:
            raise AssertionError(f"recsys restart: leaves differ: {diff}")
    log(f"recsys restart: 4 steps saved every 2, resumed at step 4; "
        f"{len(got)} restored leaves torch.equal to the saved ones; losses "
        + ", ".join(f"{x:.6f}" for x in first["losses"] + again["losses"]))

    # ---- 4. the card's reduced steps against the CPU's ----
    small = get_bundle(arch, reduced=True)
    cpu = small.init_params(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    s_cpu = init_train_state(cpu, small.opt_cfg)
    s_dev = init_train_state(card, small.opt_cfg)
    step = small._steps["train"]
    worst = 0.0
    for s in range(3):
        s_cpu, m_cpu = step(s_cpu, recsys_batch(small.cfg, 64, seed=s,
                                                device="cpu"))
        s_dev, m_dev = step(s_dev, recsys_batch(small.cfg, 64, seed=s,
                                                device=dev))
        a_, b_ = float(m_cpu["loss"]), float(m_dev["loss"])
        if abs(a_ - b_) > 1e-5 * abs(a_):
            raise AssertionError(f"recsys card vs CPU: step {s + 1} loss "
                                 f"{b_} against {a_}")
    for (n_, a), (_, b) in zip(cpu.named_parameters(),
                               card.named_parameters()):
        a, b = a.detach().double(), b.detach().cpu().double()
        if not bool(((a - b).abs() <= 1e-7 + 1e-5 * a.abs()).all()):
            raise AssertionError(f"recsys card vs CPU: {n_} differs")
        worst = max(worst, float(((a - b).abs() / (a.abs() + 1e-30)).max()))
    log(f"recsys card vs CPU: 3 reduced steps, losses within rtol 1e-5, "
        f"params within rtol 1e-5 / atol 1e-7 (largest relative difference "
        f"{worst:.3e})")


REL_L2_CHUNK = 1 << 26          # elements in float64 at a time


def rel_l2(torch, got, want) -> float:
    """||got - want|| / ||want|| in float64, over chunks of at most
    REL_L2_CHUNK elements (a float64 copy of a whole expert-weight
    gradient would take 10 GB)."""
    g, w = got.reshape(-1), want.reshape(-1)
    diff = ref = 0
    for i in range(0, g.numel(), REL_L2_CHUNK):
        gp = g[i:i + REL_L2_CHUNK].double()
        wp = w[i:i + REL_L2_CHUNK].double()
        diff = diff + torch.sum((gp - wp) ** 2)
        ref = ref + torch.sum(wp ** 2)
    return float(torch.sqrt(diff / ref))


def lm_serve_arm(torch, np, dev, launches, ops, tag, bundle):
    """One full-width serving arm of phase 5h: params from a seeded
    generator on the card, ``BatchedServer(bundle, LM_SLOTS, LM_PROMPT +
    LM_GEN + 4)`` serving seeded prompts, each decode step timed by CUDA
    events; finite logits, tokens in [0, vocab), the cache length, the
    peak against P + cache; then one more serve under the profiler.
    Returns (params, server, stats)."""
    from repro_torch.launch.serve_lm import BatchedServer

    cfg = bundle.cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    n_params = sum(p.numel() for p in params.parameters())
    init_peak = torch.cuda.max_memory_allocated() - resident
    server = BatchedServer(bundle, LM_SLOTS, LM_PROMPT + LM_GEN + 4,
                           params=params)
    cache_bytes = sum(v.numel() * v.element_size()
                      for v in server.cache.values() if torch.is_tensor(v))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_SLOTS, LM_PROMPT), dtype=np.int32)
    events, finite, logit_bytes = [], [], []
    real = server._decode

    def timed(tok):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logits = real(tok)
        stop.record()
        events.append((start, stop))
        finite.append(torch.isfinite(logits).all())
        logit_bytes.append(logits.numel() * logits.element_size())
        return logits

    server._decode = timed
    torch.cuda.reset_peak_memory_stats()
    out, wall, peak, _ = counted(torch, ops, launches, tag,
                                 lambda: server.run(prompts, LM_GEN))
    steps = [a.elapsed_time(b) for a, b in events]
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{tag}: non-finite logits")
    if out.shape != (LM_SLOTS, LM_GEN) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"{tag}: tokens {out.shape} outside [0, "
                             f"{cfg.vocab})")
    if server.cache["len"] != LM_PROMPT + LM_GEN:
        raise AssertionError(f"{tag}: cache length {server.cache['len']}")
    ran = {k: v for k, v in launches[tag].items() if v}
    if ran:
        raise AssertionError(f"{tag}: the LM path launched {ran}")
    # what a decode step must move: every weight but the embedding table,
    # of which it gathers LM_SLOTS rows (the whole table where the head is
    # tied to it), the cache positions it attends to and the one it
    # writes, and the logits; step i (from 0) attends to i + 1 positions.
    # The MoE's experts count whole: the no-drop decode reads every one.
    embed_bytes = params.embed.numel() * params.embed.element_size()
    weights = p_bytes if cfg.tie_embeddings else (
        p_bytes - embed_bytes + LM_SLOTS * embed_bytes // cfg.vocab)
    per_pos = cache_bytes / server.max_len
    step_bytes = [decode_step_bytes(weights, per_pos, i + 1, logit_bytes[i])
                  for i in range(1, len(steps))]
    bound = sum(step_bytes) / len(step_bytes) / HBM_BYTES_PER_S * 1e3
    mean = sum(steps[1:]) / len(steps[1:])
    log(f"{tag}: {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}; P = {p_bytes} bytes ({n_params} parameters, "
        f"{cfg.param_dtype}) drawn on the card in {init_s:.2f} s (init peak "
        f"{init_peak} above resident); cache {cache_bytes} bytes")
    log(f"{tag}: {LM_SLOTS} slots x ({LM_PROMPT}+{LM_GEN}) tokens in "
        f"{wall:.3f} s; decode step ms (CUDA events) steps 2-{len(steps)} "
        f"mean {mean:.3f}, min {min(steps[1:]):.3f}, step 1 {steps[0]:.3f}; "
        f"HBM bound (the weights less the embedding table's unread rows, "
        f"the cache read and written, the logits: mean "
        f"{sum(step_bytes) / len(step_bytes):.0f} bytes a step) / "
        f"{HBM_BYTES_PER_S / 1e12} TB/s = {bound:.3f} ms ({mean / bound:.2f}x)"
        f"; sample tokens {out[0][:8].tolist()}")
    above = peak - resident
    log(f"{tag}: max_memory_allocated {above} above the {resident} resident "
        f"| P + cache = {p_bytes + cache_bytes} | excess "
        f"{above - p_bytes - cache_bytes} (limit {LM_ACT_SLACK:.0f})")
    if above > p_bytes + cache_bytes + LM_ACT_SLACK:
        raise AssertionError(f"{tag}: peak {above} above P + cache + "
                             f"{LM_ACT_SLACK:.0f}")
    server._decode = real
    # a short steady window (LM_PROFILE_STEPS decode steps of a fresh
    # server) under the profiler: every step is the same work, and a
    # full serve's quarter million events take the profiler a minute
    where_the_time_goes(
        torch, lambda: BatchedServer(bundle, LM_SLOTS, LM_PROFILE_STEPS,
                                     params=params).run(
            prompts[:, :1], LM_PROFILE_STEPS - 1),
        top=10)
    return params, server, dict(p_bytes=p_bytes, step_ms=mean,
                                bound_ms=bound)


def lm_phase(torch, np, dev, launches, ops):
    """Phase 5h: the LM serving path on the card (no hand kernel runs on
    it: every arm's launch counts stay 0).

    1. minitron-8b at its full published widths: ``BatchedServer`` with
       seeded params on the card serving LM_SLOTS prompts of LM_PROMPT
       tokens for LM_GEN tokens (``lm_serve_arm``);
    2. minitron-8b prefill against decode at full width: ``lm_prefill``
       on LM_PREFILL tokens, timed; layer 0's flash attention on those
       q, k, v at full heads against naive softmax attention (float32
       scores, the causal mask); the decode loop's logits over
       LM_DECODE_CHECK positions against ``lm_hidden`` + ``lm_logits``;
    3. deepseek-v2-236b at full widths, LM_V2_LAYERS layers: served as in
       1; layer 1's no-drop MoE decode, on the hidden states it served,
       against a per-token expert loop (route, the top-6 experts, the
       shared experts); ``mla_decode`` step by step against
       ``mla_forward`` over LM_MLA_CHECK tokens;
    4. the card against the CPU at the five reduced configs (float32, the
       same params): the decode logits over 8 steps and ``lm_prefill``;
    5. ``serve_lm.main(["--arch", a])`` for each arch: rc 0."""
    import copy

    from repro_torch.configs import ALL_ARCHS, get_bundle
    from repro_torch.configs.families import make_lm_bundle
    from repro_torch.launch import serve_lm
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf_lib
    from repro_torch.models.layers import apply_rope, layer_at, rmsnorm

    lm_archs = [a for a in ALL_ARCHS
                if get_bundle(a, reduced=True).family == "lm"]
    log(f"lm: limits: bf16 comparisons relative L2 <= {LM_BF16_REL_L2}; "
        f"card vs CPU rtol / atol {LM_F32_TOL}")

    t_arm = time.perf_counter()

    def arm_done(what):
        nonlocal t_arm
        log(f"lm: {what} in {time.perf_counter() - t_arm:.1f} s")
        t_arm = time.perf_counter()

    # ---- 1. minitron-8b at full width, served ----
    bundle = get_bundle("minitron-8b", reduced=False)
    cfg = bundle.cfg
    params, server, _ = lm_serve_arm(torch, np, dev, launches, ops,
                                     "lm_minitron_serve", bundle)
    del server
    arm_done("arm 1 (minitron-8b served)")

    # ---- 2. prefill against decode at full width ----
    b_, s_ = LM_PREFILL
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (b_, s_), dtype=np.int32)).to(dev)
    tf_lib.lm_prefill(params, toks[:, :cfg.q_block], cfg)      # warm
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def prefill():
        start.record()
        out = tf_lib.lm_prefill(params, toks, cfg)
        stop.record()
        return out

    logits, wall, peak, resident = counted(torch, ops, launches,
                                           "lm_minitron_prefill", prefill)
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            b_, cfg.vocab):
        raise AssertionError(f"lm prefill: logits {tuple(logits.shape)}, "
                             "finite expected")
    flops = 2.0 * b_ * s_ * sum(p.numel() for p in params.parameters())
    log(f"lm_minitron_prefill: ({b_}, {s_}) tokens, {s_ // cfg.q_block} q "
        f"blocks x {s_ // cfg.kv_block} kv blocks of {cfg.q_block} / "
        f"{cfg.kv_block}: {start.elapsed_time(stop):.3f} ms (CUDA events; "
        f"wall {wall:.3f} s), peak {peak - resident} above resident; the "
        f"weights' matmuls alone {flops:.4g} flop = "
        f"{flops / 989e12 * 1e3:.3f} ms at 989 TFLOP/s bf16")
    with torch.no_grad():
        p0 = layer_at(params.layers, 0)
        x = rmsnorm(p0.attn_norm, params.embed[toks.long()])
        pos = torch.arange(s_, device=dev)[None, :]
        q = (x @ p0.attn.wq).reshape(b_, s_, cfg.n_heads, cfg.d_head)
        k = (x @ p0.attn.wk).reshape(b_, s_, cfg.n_kv_heads, cfg.d_head)
        v = (x @ p0.attn.wv).reshape(b_, s_, cfg.n_kv_heads, cfg.d_head)
        q = apply_rope(q.transpose(1, 2), pos[:, None], cfg.rope_theta)
        k = apply_rope(k.transpose(1, 2), pos[:, None], cfg.rope_theta)
        rep = cfg.n_heads // cfg.n_kv_heads
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v.transpose(1, 2), rep, dim=1)
        got = attn.flash_attention(q, k, v, q_block=cfg.q_block,
                                   kv_block=cfg.kv_block)
        sc = (q.float() @ k.float().transpose(-1, -2)) / cfg.d_head ** 0.5
        mask = torch.ones((s_, s_), dtype=torch.bool, device=dev).tril()
        want = torch.softmax(sc.masked_fill(~mask, -1e30), -1) @ v.float()
        del sc, mask
        err_flash = rel_l2(torch, got, want)
        del q, k, v, x, got, want
    log(f"lm flash vs naive: layer 0, q/k/v ({b_}, {cfg.n_heads}, {s_}, "
        f"{cfg.d_head}) bf16 against float32 softmax attention: relative "
        f"L2 {err_flash:.3e} (limit {LM_BF16_REL_L2})")
    if not err_flash <= LM_BF16_REL_L2:
        raise AssertionError(f"lm flash vs naive: {err_flash}")
    n = LM_DECODE_CHECK
    with torch.no_grad():
        h, _ = tf_lib.lm_hidden(params, toks[:, :n], cfg)
        full = tf_lib.lm_logits(params, h, cfg)
    cache = tf_lib.init_cache(cfg, b_, n, device=dev)
    dec = []
    for t in range(n):
        lg, cache = tf_lib.lm_decode_step(params, cache, toks[:, t], cfg)
        dec.append(lg)
    err_dec = rel_l2(torch, torch.stack(dec, 1), full)
    worst = max(rel_l2(torch, dec[t], full[:, t]) for t in range(n))
    log(f"lm decode vs prefill: {n} positions x {b_} rows of {cfg.vocab} "
        f"logits, bf16: relative L2 {err_dec:.3e} (worst position "
        f"{worst:.3e}; limit {LM_BF16_REL_L2})")
    if not err_dec <= LM_BF16_REL_L2:
        raise AssertionError(f"lm decode vs prefill: {err_dec}")
    del params, h, full, cache, dec, lg, logits, toks
    gc.collect()
    torch.cuda.empty_cache()
    arm_done("arm 2 (prefill, flash, decode vs prefill)")

    # ---- 3. deepseek-v2-236b at full widths, 3 layers ----
    v2 = get_bundle("deepseek-v2-236b", reduced=False)
    bundle = make_lm_bundle(v2.arch_id, dataclasses.replace(
        v2.cfg, n_layers=LM_V2_LAYERS), v2.opt_cfg)
    cfg = bundle.cfg
    seen = []
    real_moe = moe_lib.moe_forward

    def capture(p, x, **kw):
        out = real_moe(p, x, **kw)
        if not seen:
            seen.append((p, x.clone(), out[0].clone(), kw))
        return out

    moe_lib.moe_forward = capture
    try:
        params, server, _ = lm_serve_arm(torch, np, dev, launches, ops,
                                         "lm_deepseek_v2_serve", bundle)
    finally:
        moe_lib.moe_forward = real_moe
    p, x, out, kw = seen[0]
    if not kw.get("no_drop") or x.shape[1] != 1:
        raise AssertionError(f"lm moe: captured {kw} at {tuple(x.shape)}")
    with torch.no_grad():
        x2 = x.reshape(-1, cfg.d_model)
        idx, gates, _ = moe_lib.route(p, x2, top_k=cfg.top_k,
                                      mode=cfg.router_mode)
        loop = torch.zeros_like(x2)
        for t in range(x2.shape[0]):
            for j in range(cfg.top_k):
                e = int(idx[t, j])
                hh = (torch.nn.functional.silu(x2[t] @ p.gate[e])
                      * (x2[t] @ p.up[e]))
                loop[t] += gates[t, j] * (hh @ p.down[e])
        loop = loop + (torch.nn.functional.silu(x2 @ p.shared.gate)
                       * (x2 @ p.shared.up)) @ p.shared.down
    err_moe = rel_l2(torch, out.reshape(-1, cfg.d_model), loop)
    log(f"lm moe decode vs loop: layer 1's first served step, "
        f"{x2.shape[0]} tokens, top-{cfg.top_k} of {cfg.n_routed} experts "
        f"+ {cfg.n_shared} shared, bf16: relative L2 {err_moe:.3e} (limit "
        f"{LM_BF16_REL_L2})")
    if not err_moe <= LM_BF16_REL_L2:
        raise AssertionError(f"lm moe decode vs loop: {err_moe}")
    del seen, p, x, out, x2, loop
    n = LM_MLA_CHECK
    dims = dict(n_heads=cfg.n_heads, kv_lora=cfg.kv_lora, d_nope=cfg.d_nope,
                d_rope=cfg.d_rope, d_v=cfg.d_v, rope_theta=cfg.rope_theta)
    with torch.no_grad():
        pa = layer_at(params.dense_layers, 0).attn
        gen = torch.Generator(device=dev).manual_seed(2)
        xs = torch.randn((LM_SLOTS, n, cfg.d_model), generator=gen,
                         device=dev).to(cfg.param_dtype)
        fwd = attn.mla_forward(pa, xs, q_block=cfg.q_block,
                               kv_block=cfg.kv_block, **dims)
        cache = {"c_kv": torch.zeros((LM_SLOTS, n, cfg.kv_lora),
                                     dtype=cfg.param_dtype, device=dev),
                 "k_rope": torch.zeros((LM_SLOTS, n, cfg.d_rope),
                                       dtype=cfg.param_dtype, device=dev),
                 "len": 0}
        steps = []
        for t in range(n):
            o, cache = attn.mla_decode(pa, xs[:, t:t + 1], cache, **dims)
            steps.append(o)
        err_mla = rel_l2(torch, torch.cat(steps, 1), fwd)
    log(f"lm mla decode vs forward: layer 0, {n} steps x {LM_SLOTS} rows "
        f"(the absorbed decode on the (c_kv, k_rope) cache against the "
        f"decompressed forward), bf16: relative L2 {err_mla:.3e} (limit "
        f"{LM_BF16_REL_L2})")
    if not err_mla <= LM_BF16_REL_L2:
        raise AssertionError(f"lm mla decode vs forward: {err_mla}")
    del params, server, pa, xs, fwd, cache, steps, o
    gc.collect()
    torch.cuda.empty_cache()
    arm_done("arm 3 (deepseek-v2-236b served, MoE, MLA)")

    # ---- 4. the card against the CPU at the reduced configs ----
    worst = 0.0
    for arch in lm_archs:
        small = get_bundle(arch, reduced=True)
        cfg = small.cfg
        cpu = small.init_params(torch.Generator().manual_seed(0),
                                device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (2, 16), dtype=np.int32))
        pairs = [(tf_lib.lm_prefill(card, toks.to(dev), cfg),
                  tf_lib.lm_prefill(cpu, toks, cfg))]
        c_dev = tf_lib.init_cache(cfg, 2, 8, device=dev)
        c_cpu = tf_lib.init_cache(cfg, 2, 8, device="cpu")
        for t in range(8):
            a_, c_dev = tf_lib.lm_decode_step(card, c_dev, toks[:, t].to(dev),
                                              cfg)
            b2_, c_cpu = tf_lib.lm_decode_step(cpu, c_cpu, toks[:, t], cfg)
            pairs.append((a_, b2_))
        for a_, b2_ in pairs:
            a_, b2_ = a_.cpu().double(), b2_.double()
            if not bool(((a_ - b2_).abs()
                         <= LM_F32_TOL + LM_F32_TOL * b2_.abs()).all()):
                raise AssertionError(f"lm card vs CPU: {arch} differs by "
                                     f"{float((a_ - b2_).abs().max())}")
            worst = max(worst, float((a_ - b2_).abs().max()))
    log(f"lm card vs CPU: {len(lm_archs)} reduced archs, lm_prefill and 8 "
        f"decode steps within rtol / atol {LM_F32_TOL} (largest absolute "
        f"difference {worst:.3e})")
    arm_done("arm 4 (card vs CPU)")

    # ---- 5. the CLI, the reference's defaults ----
    for arch in lm_archs:
        ops.reset_launch_counts()
        rc = serve_lm.main(["--arch", arch])
        if rc != 0:
            raise AssertionError(f"serve_lm --arch {arch}: rc {rc}")
        launches[f"lm_cli_{arch}"] = ops.launch_counts()
    log(f"lm cli: serve_lm.main(['--arch', a]) rc 0 for {lm_archs}")
    arm_done("arm 5 (the CLI)")


def host_nbr_table(n_nodes, n_edges, seed, max_deg):
    """Phase 5i's host build of the GraphSAGE cell's neighbour table (a
    worker process: the same edges, ``build_nbr_table`` on the CPU)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models.sampler import build_nbr_table

    snd, rcv = random_graph(n_nodes, n_edges, seed)
    t0 = time.perf_counter()
    table, deg = build_nbr_table(snd, rcv, n_nodes, max_deg, device="cpu")
    return table.numpy(), deg.numpy(), time.perf_counter() - t0


def check_specs(tag, batch, specs):
    """The batch's keys, shapes and dtypes are the bundle's input specs of
    its cell; returns the batch bytes."""
    if sorted(batch) != sorted(specs):
        raise AssertionError(f"{tag}: batch keys {list(batch)} against the "
                             f"specs' {list(specs)}")
    for k, v in specs.items():
        if tuple(batch[k].shape) != v.shape or batch[k].dtype != v.dtype:
            raise AssertionError(f"{tag}: {k} {tuple(batch[k].shape)} "
                                 f"{batch[k].dtype} against the spec {v}")
    return sum(t.numel() * t.element_size() for t in batch.values())


def timed_steps(torch, np, step, state, batches, tag):
    """One train step per batch (``batches``: an iterable of batches or of
    functions making one), each step timed by CUDA events; finite losses.
    Returns (state, ms per step, losses)."""
    ms, losses = [], []
    for b in batches:
        batch = b() if callable(b) else b
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        stop.record()
        torch.cuda.synchronize()
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"{tag}: step {len(ms) + 1} loss {loss}")
        ms.append(start.elapsed_time(stop))
        losses.append(loss)
    return state, ms, losses


def gnn_full_arm(torch, np, dev, launches, ops, arch, cell, make_batches):
    """One full-width GNN arm of phase 5i: the registry's full config and
    its ``cell``'s step on the card, params from a seeded generator,
    GNN_STEPS steps on the batches ``make_batches(bundle, gen)`` returns
    (each held to the cell's input specs), every param changed, the ms of
    steps 2-3, the peak above resident; one more step profiled."""
    from repro_torch.configs import get_bundle
    from repro_torch.train.train_step import init_train_state

    tag = f"gnn_{arch}"
    bundle = get_bundle(arch, reduced=False)
    kind, step = bundle.step_for(cell)
    specs = bundle.input_specs(cell)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init_params(gen)
    state = init_train_state(params, bundle.opt_cfg)
    n_params = sum(p.numel() for p in params.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    before = [p.detach().clone() for p in params.parameters()]
    batches = make_batches(bundle, gen)
    checked = []

    def checked_batch(b):
        def make():
            batch = b() if callable(b) else b
            checked.append(check_specs(tag, batch, specs))
            return batch
        return make

    (state, ms, losses), wall, _, _ = counted(
        torch, ops, launches, tag,
        lambda: timed_steps(torch, np, step, state,
                            [checked_batch(b) for b in batches], tag))
    ran = {k: v for k, v in launches[tag].items() if v}
    if ran:
        raise AssertionError(f"{tag}: the GNN path launched {ran}")
    same = [n for (n, p), b in zip(params.named_parameters(), before)
            if torch.equal(p.detach(), b)]
    if same:
        raise AssertionError(f"{tag}: params unchanged after {GNN_STEPS} "
                             f"steps: {same}")
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: {bundle.cfg.name} full config, cell {cell} ({kind}), "
        f"{n_params} params ({p_bytes} bytes), batch {checked[0]} bytes "
        f"(== the cell's specs); losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + " | step ms " + ", ".join(f"{x:.3f}" for x in ms)
        + f" (steps 2-{GNN_STEPS} mean {sum(ms[1:]) / len(ms[1:]):.3f}) | "
        f"peak {peak - resident} bytes above the {resident} resident | "
        f"every param changed | wall {wall:.3f} s")
    last = batches[-1]
    batch = last() if callable(last) else last
    where_the_time_goes(torch, lambda: step(state, batch), top=8)
    del state, params, before, batches, batch
    gc.collect()
    torch.cuda.empty_cache()


def gnn_lm_train_phase(torch, np, dev, launches, ops, oracles):
    """Phase 5i: the training path of the GNN family and the LM (no hand
    kernel runs on it: every launch count stays 0).

    1. the four GNNs at their full published widths, each on its
       registry cell (``gnn_full_arm``): graphsage-reddit's
       ``minibatch_lg`` through ``train_sampled``, the sampler on the
       card over the cell's 232,965-node, 114,615,892-edge graph (the
       neighbour table built on the card ``torch.equal`` to the port's
       host build, run in a worker; every sampled neighbour in its node's
       table row, -1 only at degree 0; the table build's and the
       sampler's times); meshgraphnet on ``minibatch_lg``'s graph view,
       dimenet on ``molecule``, graphcast on ``minibatch_lg``'s grid;
    2. minitron-8b at full widths cut to LM_TRAIN_LAYERS layers, batch 1
       of ``train_4k``'s 4,096 tokens, remat on: LM_TRAIN_STEPS steps
       timed, the peak against P + AdamW state + gradients + logits; at
       LM_REMAT_LAYERS layers the loss with remat on and off equal, the
       gradients within relative L2 LM_REMAT_REL_L2;
    3. the card against the CPU at the reduced configs: two train steps
       (AdamW without warmup) of each GNN and of GraphSAGE's
       ``train_sampled`` on the same blocks, losses and params within
       rtol / atol GNN_F32_TOL;
    4. ``train.main(["--arch", a, "--steps", "3"])`` for every arch:
       rc 0."""
    import copy

    from repro_torch.configs import ALL_ARCHS, get_bundle
    from repro_torch.configs.families import (_gnn_graph_dims,
                                              make_gnn_bundle,
                                              make_lm_bundle)
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import train as train_cli
    from repro_torch.models.sampler import (build_nbr_table, sample_block,
                                            sample_blocks)
    from repro_torch.train.train_step import init_train_state

    t_arm = time.perf_counter()

    def arm_done(what):
        nonlocal t_arm
        log(f"train: {what} in {time.perf_counter() - t_arm:.1f} s")
        t_arm = time.perf_counter()

    # ---- 1. the four GNNs at full width ----
    cell = GNN_SHAPES["minibatch_lg"]
    n_nodes, n_edges = cell.n_nodes, cell.n_edges
    snd, rcv = syn.random_graph(n_nodes, n_edges, GNN_GRAPH_SEED)
    t0 = time.perf_counter()
    snd_d = torch.from_numpy(snd).to(dev)
    rcv_d = torch.from_numpy(rcv).to(dev)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    del snd, rcv
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table, deg = build_nbr_table(snd_d, rcv_d, n_nodes, GNN_MAX_DEG,
                                 device=dev)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    del snd_d, rcv_d
    host_t, host_d, host_s = oracles[("nbr_table",)].result()
    if not (torch.equal(table.cpu(), torch.from_numpy(host_t))
            and torch.equal(deg.cpu(), torch.from_numpy(host_d))):
        raise AssertionError("gnn nbr_table: the card's table differs from "
                             "the host build of the same edges")
    log(f"gnn nbr_table: {n_nodes} nodes, {n_edges} edges (max_deg "
        f"{GNN_MAX_DEG}): built on the card in {t_table * 1e3:.3f} ms "
        f"(edges uploaded in {upload:.3f} s), torch.equal to the host build "
        f"({host_s:.2f} s in a worker); {int((deg == GNN_MAX_DEG).sum())} "
        f"senders truncated, {int((deg == 0).sum())} isolated")
    sample_ms = []

    def sage_batches(bundle, gen):
        cfg = bundle.cfg
        feats = torch.randn((n_nodes, cfg.d_in), generator=gen, device=dev)
        # the sampled neighbours of the seeds and of their frontier: in
        # their node's table row, -1 exactly where the degree is 0
        seeds = torch.randperm(n_nodes, generator=gen, device=dev)[
            :cell.batch_nodes]
        frontier = seeds
        for f in cell.fanout:
            nb, nxt = sample_block(gen, table, deg, frontier, f)
            rows = table[frontier.long()]
            hit = (nb[:, :, None] == rows[:, None, :]).any(-1)
            isolated = (deg[frontier.long()] == 0)[:, None]
            if not bool(torch.where(nb >= 0, hit, isolated).all()) or \
                    not bool(((nb == -1) == isolated.expand_as(nb)).all()):
                raise AssertionError("gnn sampler: a neighbour outside its "
                                     "node's table row")
            frontier = nxt
        log(f"gnn sampler: {cell.batch_nodes} seeds, fanout {cell.fanout}: "
            "every sampled neighbour in its node's table row, -1 only at "
            "degree 0")

        def make():
            seeds = torch.randperm(n_nodes, generator=gen, device=dev)[
                :cell.batch_nodes].to(torch.int32)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            blocks = sample_blocks(gen, table, deg, feats, seeds,
                                   cell.fanout)
            stop.record()
            torch.cuda.synchronize()
            sample_ms.append(start.elapsed_time(stop))
            blocks["labels"] = torch.randint(
                0, cfg.n_classes, (cell.batch_nodes,), generator=gen,
                device=dev, dtype=torch.int32)
            return blocks

        return [make] * GNN_STEPS

    gnn_full_arm(
        torch, np, dev, launches, ops, "graphsage-reddit", "minibatch_lg",
        sage_batches)
    log(f"gnn sampler: sample_blocks ms per batch (CUDA events) "
        + ", ".join(f"{x:.3f}" for x in sample_ms))
    del table, deg
    n_mg, e_mg = _gnn_graph_dims(cell)
    gnn_full_arm(
        torch, np, dev, launches, ops, "meshgraphnet", "minibatch_lg",
        lambda b, gen: [syn.meshgraphnet_batch(b.cfg, n_mg, e_mg, seed=s,
                                               device=dev)
                        for s in range(GNN_STEPS)])
    mol = GNN_SHAPES["molecule"]
    gnn_full_arm(
        torch, np, dev, launches, ops, "dimenet", "molecule",
        lambda b, gen: [syn.dimenet_batch(
            b.cfg, mol.batch * mol.n_nodes, mol.batch * mol.n_edges,
            n_graphs=mol.batch, triplet_fanout=mol.triplet_fanout, seed=s,
            device=dev) for s in range(GNN_STEPS)])
    gnn_full_arm(
        torch, np, dev, launches, ops, "graphcast", "minibatch_lg",
        lambda b, gen: [syn.graphcast_batch(b.cfg, n_mg, seed=s, device=dev)
                        for s in range(GNN_STEPS)])
    arm_done("arm 1 (the four GNNs at full width)")

    # ---- 2. minitron-8b training at full widths, 4 layers ----
    base = get_bundle("minitron-8b", reduced=False)
    seq = base.shapes["train_4k"].seq_len
    bundle = make_lm_bundle(base.arch_id, dataclasses.replace(
        base.cfg, n_layers=LM_TRAIN_LAYERS), base.opt_cfg)
    cfg = bundle.cfg
    n_params = sum(p.numel() for p in bundle.abstract_params().parameters())
    p_bytes = n_params * torch.finfo(cfg.param_dtype).bits // 8
    state_bytes = 2 * n_params * torch.finfo(
        bundle.opt_cfg.state_dtype).bits // 8
    # the logits in bf16, their float32 image in the loss, and the
    # gradient of each
    logit_bytes = 2 * seq * cfg.vocab * (2 + 4)
    reckoned = 2 * p_bytes + state_bytes + logit_bytes
    log(f"lm_train: {cfg.name} at full widths, {cfg.n_layers} layers, "
        f"{n_params} params: P = {p_bytes} bytes ({cfg.param_dtype}), "
        f"AdamW m + v {state_bytes} ({bundle.opt_cfg.state_dtype}), "
        f"gradients P, logits + their float32 image and gradients "
        f"{logit_bytes}: reckoned {reckoned} bytes; batch 1 x {seq} tokens, "
        f"remat {cfg.remat}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = bundle.init_params(gen)
    state = init_train_state(params, bundle.opt_cfg)
    step = bundle._steps["train"]
    batches = [syn.lm_train_batch(cfg.vocab, 1, seq, seed=s, device=dev)
               for s in range(LM_TRAIN_STEPS)]
    (state, ms, losses), wall, _, _ = counted(
        torch, ops, launches, "lm_train",
        lambda: timed_steps(torch, np, step, state, batches, "lm_train"))
    peak = torch.cuda.max_memory_allocated() - resident
    ran = {k: v for k, v in launches["lm_train"].items() if v}
    if ran:
        raise AssertionError(f"lm_train: the LM path launched {ran}")
    # forward and backward of every weight but the embedding table (a
    # gather): 6 flop per weight and token
    flops = 6.0 * seq * (n_params - cfg.vocab * cfg.d_model)
    log(f"lm_train: losses " + ", ".join(f"{x:.6f}" for x in losses)
        + " | step ms " + ", ".join(f"{x:.3f}" for x in ms)
        + f" (steps 2-{LM_TRAIN_STEPS} mean {sum(ms[1:]) / len(ms[1:]):.3f})"
        f" | the weights' matmuls 6 (N - V d) S = {flops:.4g} flop = "
        f"{flops / 989e12 * 1e3:.3f} ms at 989 TFLOP/s bf16 | peak {peak} "
        f"bytes above resident = {peak / reckoned:.3f} x reckoned")
    where_the_time_goes(torch, lambda: step(state, batches[0]), top=8)
    del state, params, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    arm_done("arm 2 (minitron-8b trained, 4 layers)")

    small_cfg = dataclasses.replace(base.cfg, n_layers=LM_REMAT_LAYERS)
    on = make_lm_bundle(base.arch_id, small_cfg, base.opt_cfg)
    off = make_lm_bundle(base.arch_id, dataclasses.replace(
        small_cfg, remat=False), base.opt_cfg)
    params = on.init_params(torch.Generator(device=dev).manual_seed(1))
    leaves = list(params.parameters())
    batch = syn.lm_train_batch(cfg.vocab, 1, seq, seed=7, device=dev)
    got = {}
    for name, b in (("on", on), ("off", off)):
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.enable_grad():
            loss = b._loss_fn(params, batch)[0]
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        got[name] = (loss.detach(), grads,
                     torch.cuda.max_memory_allocated() - base_mem)
        del loss, grads
    (l_on, g_on, pk_on), (l_off, g_off, pk_off) = got["on"], got["off"]
    num = sum(float(torch.sum((a.double() - b.double()) ** 2))
              for a, b in zip(g_on, g_off))
    den = sum(float(torch.sum(b.double() ** 2)) for b in g_off)
    err = (num / den) ** 0.5
    log(f"lm remat: {LM_REMAT_LAYERS} layers, 1 x {seq} tokens: loss remat "
        f"on {float(l_on):.9f}, off {float(l_off):.9f} (equal: "
        f"{bool(torch.equal(l_on, l_off))}); gradients relative L2 "
        f"{err:.3e} (limit {LM_REMAT_REL_L2}); peak above the params "
        f"{pk_on} bytes on, {pk_off} off")
    if not torch.equal(l_on, l_off):
        raise AssertionError(f"lm remat: loss {float(l_on)} on, "
                             f"{float(l_off)} off")
    if not err <= LM_REMAT_REL_L2:
        raise AssertionError(f"lm remat: gradients relative L2 {err}")
    del got, g_on, g_off, params, leaves, batch
    gc.collect()
    torch.cuda.empty_cache()
    arm_done("arm 2b (remat on against off)")

    # ---- 3. the card against the CPU at the reduced configs ----
    rtol, atol = GNN_F32_TOL
    worst = 0.0
    cases = []
    for arch in ("meshgraphnet", "graphsage-reddit", "dimenet",
                 "graphcast"):
        cases.append((arch, "train", lambda c, a=arch, s=0: (
            train_cli.make_batch_fn(get_bundle(a, reduced=True), 8, 64,
                                    device="cpu")(s))))
    cases.append(("graphsage-reddit", "train_sampled", lambda c, s=0: (
        syn.graphsage_sampled_batch(c, batch_nodes=32,
                                    fanouts=c.sample_sizes, n_nodes=500,
                                    n_edges=2500, seed=s, device="cpu"))))
    for arch, kind, make in cases:
        small = get_bundle(arch, reduced=True)
        small = make_gnn_bundle(arch, small.cfg, dataclasses.replace(
            small.opt_cfg, warmup_steps=0, schedule="constant"))
        step = small._steps[kind]
        cpu = small.init_params(torch.Generator().manual_seed(0))
        card = copy.deepcopy(cpu).to(dev)
        s_cpu = init_train_state(cpu, small.opt_cfg)
        s_dev = init_train_state(card, small.opt_cfg)
        for s in range(2):
            batch = make(small.cfg, s=s)
            s_cpu, m_cpu = step(s_cpu, batch)
            s_dev, m_dev = step(s_dev, {k: v.to(dev)
                                        for k, v in batch.items()})
            a_, b_ = float(m_cpu["loss"]), float(m_dev["loss"])
            if abs(a_ - b_) > atol + rtol * abs(a_):
                raise AssertionError(f"gnn card vs CPU: {arch} {kind} step "
                                     f"{s + 1} loss {b_} against {a_}")
        for (n_, a), (_, b) in zip(cpu.named_parameters(),
                                   card.named_parameters()):
            a, b = a.detach().double(), b.detach().cpu().double()
            if not bool(((a - b).abs() <= atol + rtol * a.abs()).all()):
                raise AssertionError(f"gnn card vs CPU: {arch} {kind} {n_} "
                                     "differs")
            worst = max(worst, float((a - b).abs().max()))
    log(f"gnn card vs CPU: {len(cases)} reduced cases (the four GNNs' "
        f"train, GraphSAGE's train_sampled on the same blocks), two steps "
        f"each: losses and params within rtol {rtol} / atol {atol} (largest "
        f"absolute difference {worst:.3e})")
    arm_done("arm 3 (card vs CPU)")

    # ---- 4. the CLI, the reference's defaults ----
    for arch in ALL_ARCHS:
        ops.reset_launch_counts()
        rc = train_cli.main(["--arch", arch, "--steps", "3"])
        if rc != 0:
            raise AssertionError(f"train --arch {arch}: rc {rc}")
        launches[f"train_cli_{arch}"] = ops.launch_counts()
    log(f"train cli: train.main(['--arch', a, '--steps', '3']) rc 0 for "
        f"{ALL_ARCHS}")
    arm_done("arm 4 (the CLI)")


def nbytes(torch, shape, dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype``."""
    n = 1
    for m in shape:
        n *= int(m)
    return n * torch.empty((), dtype=dtype).element_size()


def spec_bytes(torch, leaves, specs):
    """(bytes of every leaf, bytes of one position's pieces) over the
    (path, tensor-or-ShapeDtype) ``leaves``, ``specs`` by path; each
    piece's shape from ``shard_shape`` (which raises where a split dim
    does not divide)."""
    whole = per = 0
    for path, leaf in leaves:
        shape = tuple(leaf.shape)
        whole += nbytes(torch, shape, leaf.dtype)
        per += nbytes(torch, specs[path].shard_shape(shape), leaf.dtype)
    return whole, per


def sharding_phase(torch, np, dev, launches, ops):
    """Phase 5j: the sharding layer on the card (no hand kernel runs on
    it: every arm's launch counts stay 0).

    a. every arch's full config: ``param_shardings`` and
       ``state_shardings`` on ``make_production_mesh()`` and
       ``make_production_mesh(multi_pod=True)`` over meta devices, and
       ``input_shardings`` of every shape cell; each leaf's piece shape
       divides; the bytes one position holds (host only, nothing
       allocated);
    b. minitron-8b's full params (seeded, on the card) placed by
       ``lm_param_specs`` on a (2, 2) mesh whose four positions are
       ``cuda:0``: every piece its spec's ``shard_shape`` and a view of
       its param, the peak above resident under SHARD_PLACE_SLACK x P,
       ``unshard`` ``torch.equal`` to the param;
    c. deepseek-v2-236b's MoE layer at its published widths, x
       SHARD_MOE_X bf16, cf = E / k (no token dropped: every group's and
       every position's largest expert load checked against its
       capacity): the local path against ``moe_forward`` under
       ``mesh_context`` of each SHARD_MESHES mesh of ``cuda:0`` positions
       (the sharded schedule; relative L2 <= LM_BF16_REL_L2), ms by CUDA
       events (second call), the peak above resident, the bytes each
       position sends in the two exchanges; then a backward at
       SHARD_MOE_BWD on (2, 2): the gradients of x and of the routed
       weights within SHARD_GRAD_REL_L2;
    d. deepseek-v2-236b at full widths cut to LM_V2_LAYERS layers,
       capacity factor E / k: ``lm_prefill`` on LM_PREFILL tokens under
       ``mesh_context`` of the (2, 2) mesh (its two MoE layers on the
       sharded schedule) against the call without a mesh, logits within
       LM_BF16_REL_L2; both arms' ms (second call)."""
    from repro_torch.configs import ALL_ARCHS, get_bundle
    from repro_torch.configs.families import make_lm_bundle
    from repro_torch.launch import sharding as shard_lib
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf_lib
    from repro_torch.train.tree import leaves_with_paths

    def flat(tree):
        return [(shard_lib.norm_path(p), t) for p, t in
                leaves_with_paths(tree)]

    def no_kernel(tag):
        ran = {k: v for k, v in launches[tag].items() if v}
        if ran:
            raise AssertionError(f"{tag}: the sharding path launched {ran}")

    t_arm = time.perf_counter()

    def arm_done(what):
        nonlocal t_arm
        log(f"sharding: {what} in {time.perf_counter() - t_arm:.1f} s")
        t_arm = time.perf_counter()

    # ---- a. the production meshes' spec trees, host only ----
    meta = torch.device("meta")
    for multi_pod in (False, True):
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod, devices=[meta] * n)
        shape = tuple(mesh.shape.values())
        for arch in ALL_ARCHS:
            b = get_bundle(arch, reduced=False)
            pspec = dict(flat(b.param_shardings(mesh)))
            p_all, p_per = spec_bytes(torch, flat(b.abstract_params()), pspec)
            sspec = dict(flat(b.state_shardings(mesh)))
            s_all, s_per = spec_bytes(torch, flat(b.state_abstract()), sspec)
            i_per = {}
            for cell in b.shapes:
                ispec = dict(flat(b.input_shardings(cell, mesh)))
                i_per[cell] = spec_bytes(torch, flat(b.input_specs(cell)),
                                         ispec)[1]
            log(f"sharding specs {shape} {arch}: params {p_all} bytes, "
                f"{p_per} per position (1/{p_all / p_per:.1f}); train "
                f"state {s_all}, {s_per} per position; inputs per position "
                + ", ".join(f"{c} {v}" for c, v in i_per.items()))
    arm_done("a (production spec trees, host only)")

    # ---- b. placement of minitron-8b's full params ----
    bundle = get_bundle("minitron-8b", reduced=False)
    gc.collect()
    torch.cuda.empty_cache()
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    p_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    mesh22 = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
    specs = dict(flat(bundle.param_shardings(mesh22)))
    leaves = flat(params)

    def place():
        with torch.no_grad():
            return {path: specs[path].shard(t) for path, t in leaves}

    placed, wall, peak, resident = counted(torch, ops, launches,
                                           "shard_placement", place)
    no_kernel("shard_placement")
    above = peak - resident
    n_pieces = split = 0
    with torch.no_grad():
        for path, t in leaves:
            spec = specs[path]
            local = spec.shard_shape(t.shape)
            split += local != tuple(t.shape)
            for piece in placed[path]:
                n_pieces += 1
                if tuple(piece.shape) != local or \
                        piece.untyped_storage().data_ptr() != \
                        t.untyped_storage().data_ptr():
                    raise AssertionError(f"placement {path}: piece "
                                         f"{tuple(piece.shape)} of {local}, "
                                         "or not a view")
            if not torch.equal(spec.unshard(placed[path], dev), t):
                raise AssertionError(f"placement {path}: unshard differs")
    log(f"shard_placement: minitron-8b, P = {p_bytes} bytes, {len(leaves)} "
        f"leaves ({split} split) on a (2, 2) mesh of cuda:0 positions: "
        f"{n_pieces} pieces, each its shard_shape and a view, in {wall:.3f}"
        f" s; peak above resident {above} (limit "
        f"{SHARD_PLACE_SLACK * p_bytes:.0f}); unshard torch.equal for "
        "every leaf")
    if above > SHARD_PLACE_SLACK * p_bytes:
        raise AssertionError(f"placement peak {above} above "
                             f"{SHARD_PLACE_SLACK} x P")
    del placed, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    arm_done("b (placement at full width)")

    # ---- c. deepseek-v2-236b's MoE layer at its published widths ----
    v2 = get_bundle("deepseek-v2-236b", reduced=False)
    cfg = v2.cfg
    d, f, n_e, k = cfg.d_model, cfg.d_ff_moe, cfg.n_routed, cfg.top_k
    cf = n_e / k
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe_lib.init_moe(gen, d, f, n_e, cfg.n_shared,
                         dtype=cfg.param_dtype, device=dev)
    routed = sum(t.numel() * t.element_size() for t in (p.gate, p.up, p.down))
    shared_w = sum(t.numel() * t.element_size()
                   for t in p.shared.parameters()) if cfg.n_shared else 0
    bsz, seq = SHARD_MOE_X
    x = torch.randn((bsz, seq, d), generator=gen, device=dev).to(
        cfg.param_dtype)
    gs = min(cfg.moe_group_size, seq)
    el = x.element_size()
    log(f"shard_moe: deepseek-v2-236b's MoE layer, d {d}, {n_e} routed "
        f"experts top-{k} of d_ff {f} ({routed} bytes bf16), "
        f"{cfg.n_shared} shared; x {tuple(x.shape)} bf16, cf = E / k = "
        f"{cf:.4f}; reckoned: the local dispatch ({bsz * seq // gs}, {n_e}, "
        f"{gs}, {d}) = {bsz * seq // gs * n_e * gs * d * el} bytes, its "
        "output as much")

    def largest_load(tokens, groups):
        """The most tokens any expert receives in any of ``groups``
        equal token groups of ``tokens`` (T, d)."""
        with torch.no_grad():
            idx, _, _ = moe_lib.route(
                p, tokens.reshape(groups, -1, d), top_k=k,
                mode=cfg.router_mode)
            one = torch.zeros(groups, n_e, dtype=torch.int64, device=dev)
            one.scatter_add_(1, idx.reshape(groups, -1),
                             torch.ones_like(idx.reshape(groups, -1)))
            return int(one.max())

    load = largest_load(x.reshape(-1, d), bsz * seq // gs)
    if load > int(gs * k / n_e * cf):
        raise AssertionError(f"shard_moe: a local group drops ({load})")

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            fn()                                        # warm
            torch.cuda.synchronize()
            start.record()
            out = fn()
            stop.record()
        return out, start, stop

    def local_call():
        return moe_lib.moe_forward(p, x, top_k=k, capacity_factor=cf,
                                   mode=cfg.router_mode,
                                   group_size=cfg.moe_group_size)

    (want, _), start, stop = counted(torch, ops, launches, "shard_moe_local",
                                     lambda: timed(local_call))[0]
    no_kernel("shard_moe_local")
    torch.cuda.synchronize()
    local_ms = start.elapsed_time(stop)
    def local_again():
        with torch.no_grad():
            return local_call()

    peak_local = counted(torch, ops, launches, "shard_moe_local",
                         local_again)
    log(f"shard_moe_local: {local_ms:.3f} ms (CUDA events, second call); "
        f"peak above resident {peak_local[2] - peak_local[3]}")
    del peak_local
    calls = []
    real = moe_lib.moe_forward_sharded

    def spy(*a, **kw):
        calls.append(kw["mesh"])
        return real(*a, **kw)

    moe_lib.moe_forward_sharded = spy
    try:
        for shape in SHARD_MESHES:
            mesh = make_mesh(shape, ("data", "model"), devices=[dev] * 4)
            n_dp, n_model = shape
            t_loc = bsz // n_dp * (seq // n_model)
            cap = int(t_loc * k / n_e * cf)
            pos_load = largest_load(
                x.reshape(n_dp, bsz // n_dp, n_model, seq // n_model, d)
                .transpose(1, 2).reshape(-1, d), n_dp * n_model)
            if pos_load > cap:
                raise AssertionError(f"shard_moe {shape}: a position drops")
            tag = f"shard_moe_{shape[0]}x{shape[1]}"

            def sharded():
                with shard_lib.mesh_context(mesh):
                    return timed(local_call)

            calls.clear()
            (got, _), start, stop = counted(torch, ops, launches, tag,
                                            sharded)[0]
            no_kernel(tag)
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop)
            if len(calls) != 2 or calls[0] is not mesh:
                raise AssertionError(f"{tag}: the sharded schedule ran "
                                     f"{len(calls)} times, not twice")

            def again():
                with shard_lib.mesh_context(mesh), torch.no_grad():
                    return local_call()

            _, _, peak, resident = counted(torch, ops, launches, tag, again)
            err = rel_l2(torch, got, want)
            e_loc = n_e // n_model
            a2a = (n_model - 1) * e_loc * cap * d * el
            fsdp = (n_dp - 1) * routed // n_model // n_dp
            # the shared experts' weights lie in n_dp * n_model pieces
            # and every position puts them together whole
            shared_in = shared_w - shared_w // (n_dp * n_model)
            log(f"{tag}: {n_dp * n_model} positions on cuda:0, t_loc "
                f"{t_loc} tokens, cap {cap} (largest position load "
                f"{pos_load}, local group load {load}): {ms:.3f} ms (CUDA "
                f"events, second call) against the local {local_ms:.3f}; "
                f"relative L2 {err:.3e} (limit {LM_BF16_REL_L2}); "
                f"reckoned from the shapes, not measured: each position "
                f"sends {a2a} bytes in the dispatch exchange and {a2a} in "
                f"the return (a ({e_loc}, {cap}, {d}) bf16 piece to each "
                f"of {n_model - 1} others), receives {fsdp} bytes of "
                f"routed expert weights in the FSDP gather and {shared_in}"
                f" bytes of the shared experts' weights (put together "
                f"whole); one position's dispatch ({n_e}, {cap}, {d}) = "
                f"{n_e * cap * d * el} bytes; peak above resident "
                f"{peak - resident}")
            if not err <= LM_BF16_REL_L2:
                raise AssertionError(f"{tag}: relative L2 {err}")
            del got
        # the backward at SHARD_MOE_BWD on the (2, 2) mesh
        mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
        xb = x[:SHARD_MOE_BWD[0], :SHARD_MOE_BWD[1]].contiguous()
        w = torch.randn(xb.shape, generator=gen, device=dev)
        grads = {}
        for arm in ("local", "sharded"):
            tag = f"shard_moe_bwd_{arm}"

            def step():
                p.zero_grad(set_to_none=True)
                xx = xb.clone().requires_grad_(True)
                if arm == "sharded":
                    with shard_lib.mesh_context(mesh):
                        out, _ = moe_lib.moe_forward(
                            p, xx, top_k=k, capacity_factor=cf,
                            mode=cfg.router_mode)
                else:
                    out, _ = moe_lib.moe_forward(
                        p, xx, top_k=k, capacity_factor=cf,
                        mode=cfg.router_mode)
                (out.float() * w).sum().backward()
                return dict(x=xx.grad, gate=p.gate.grad, up=p.up.grad,
                            down=p.down.grad)

            calls.clear()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)

            def timed_step():
                step()                                  # warm
                torch.cuda.synchronize()
                start.record()
                g = step()
                stop.record()
                return g

            grads[arm], _, peak, resident = counted(torch, ops, launches,
                                                    tag, timed_step)
            no_kernel(tag)
            p.zero_grad(set_to_none=True)
            log(f"{tag}: x {tuple(xb.shape)}, forward + backward "
                f"{start.elapsed_time(stop):.3f} ms (CUDA events, second "
                f"call), peak above resident {peak - resident}")
            if (arm == "sharded") != bool(calls):
                raise AssertionError(f"{tag}: the sharded schedule ran "
                                     f"{len(calls)} times")
    finally:
        moe_lib.moe_forward_sharded = real
    errs = {n: rel_l2(torch, grads["sharded"][n], grads["local"][n])
            for n in grads["local"]}
    log("shard_moe_bwd: gradients sharded vs local, relative L2 "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (limit {SHARD_GRAD_REL_L2})")
    if not max(errs.values()) <= SHARD_GRAD_REL_L2:
        raise AssertionError(f"shard_moe_bwd: {errs}")
    del p, x, xb, want, grads, w
    gc.collect()
    torch.cuda.empty_cache()
    arm_done("c (deepseek-v2-236b's MoE layer sharded)")

    # ---- d. the sharded LM forward: deepseek-v2-236b cut to 3 layers ----
    bundle = make_lm_bundle(v2.arch_id, dataclasses.replace(
        cfg, n_layers=LM_V2_LAYERS, capacity_factor=cf), v2.opt_cfg)
    cfg3 = bundle.cfg
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    p_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    b_, s_ = LM_PREFILL
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg3.vocab, (b_, s_), dtype=np.int32)).to(dev)
    arms = {}
    for arm in ("local", "sharded"):
        ctx = shard_lib.mesh_context(mesh) if arm == "sharded" else None
        tag = f"shard_prefill_{arm}"
        moe_lib.moe_forward_sharded = spy
        calls.clear()
        try:
            def call():
                if ctx is None:
                    return timed(lambda: tf_lib.lm_prefill(params, toks,
                                                           cfg3))
                with ctx:
                    return timed(lambda: tf_lib.lm_prefill(params, toks,
                                                           cfg3))

            (logits, start, stop), _, peak, resident = counted(
                torch, ops, launches, tag, call)
        finally:
            moe_lib.moe_forward_sharded = real
        no_kernel(tag)
        want_calls = 2 * (cfg3.n_layers - cfg3.n_dense_layers) \
            if ctx else 0
        if len(calls) != want_calls:
            raise AssertionError(f"{tag}: the sharded schedule ran "
                                 f"{len(calls)} times, not {want_calls}")
        if ctx is not None and not ctx.record:
            raise AssertionError(f"{tag}: shard_act recorded nothing")
        if not bool(torch.isfinite(logits).all()) or logits.shape != (
                b_, cfg3.vocab):
            raise AssertionError(f"{tag}: logits {tuple(logits.shape)}")
        arms[arm] = (logits, start.elapsed_time(stop), peak - resident)
        if ctx is not None:
            log(f"{tag}: shard_act checked {len(ctx.record)} distinct "
                "(entries, shape) specs, e.g. " + "; ".join(
                    f"{e} {s} -> {tuple(sp)}" for (e, s), sp in
                    list(ctx.record.items())[:3]))
    err = rel_l2(torch, arms["sharded"][0], arms["local"][0])
    log(f"shard_prefill: deepseek-v2-236b, {cfg3.n_layers} layers at full "
        f"widths (P = {p_bytes} bytes), cf = E / k, ({b_}, {s_}) tokens: "
        f"local {arms['local'][1]:.3f} ms, under the (2, 2) mesh "
        f"{arms['sharded'][1]:.3f} ms (CUDA events, second call); peaks "
        f"above resident {arms['local'][2]} / {arms['sharded'][2]}; logits "
        f"relative L2 {err:.3e} (limit {LM_BF16_REL_L2})")
    if not err <= LM_BF16_REL_L2:
        raise AssertionError(f"shard_prefill: relative L2 {err}")
    del params, arms, logits, toks
    gc.collect()
    torch.cuda.empty_cache()
    arm_done("d (the sharded prefill)")


def sparse_edge_supports(np, a, eu, ev):
    """Closed-form edge supports of a card matrix at the slots, from a
    scipy sparse int64 product on the host (the slots' absent cells 0)."""
    import scipy.sparse as sp

    dense = a.cpu().numpy()
    r, c = np.nonzero(dense)
    m = sp.csr_matrix((np.ones(r.size, np.int64), (r, c)), shape=dense.shape)
    m3 = (m @ (m.T @ m)).tocsr()
    du = np.asarray(m.sum(axis=1)).ravel()
    dv = np.asarray(m.sum(axis=0)).ravel()
    eu, ev = np.array(eu.cpu().numpy()), np.array(ev.cpu().numpy())
    b = np.asarray(m3[eu, ev]).ravel() - du[eu] - dv[ev] + 1
    return (b * (dense[eu, ev] > 0)).astype(np.float32)


def host_dryrun(root: str, out: str):
    """Phase 5k's dry run in a pool worker: ``repro_torch.launch.dryrun``
    over every cell on both production meshes of meta positions, its
    stdout and stderr to ``out`` + ``.log``.  Returns (exit code, wall s,
    the records)."""
    import contextlib
    import io

    sys.path.insert(0, str(Path(root) / "src"))
    from repro_torch.launch import dryrun

    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).unlink(missing_ok=True)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = dryrun.main(["--all", "--multi-pod", "both", "--out", out])
    wall = time.perf_counter() - t0
    Path(out + ".log").write_text(buf.getvalue())
    return rc, wall, json.loads(Path(out).read_text())


def calibration_bundles():
    """Phase 5k's two LM arms: minitron-8b at its full widths with a
    decode shape of phase 5h's slots and cache length, and cut to phase
    5i's LM_TRAIN_LAYERS layers with a train shape of (1, 4,096)."""
    from repro_torch.configs import get_bundle
    from repro_torch.configs.families import make_lm_bundle
    from repro_torch.configs.shapes import LMShape

    base = get_bundle("minitron-8b")
    seq = base.shapes["train_4k"].seq_len
    decode = make_lm_bundle(base.arch_id, base.cfg, base.opt_cfg, shapes={
        "decode": LMShape("decode", LM_PROMPT + LM_GEN + 4, LM_SLOTS)})
    train = make_lm_bundle(
        base.arch_id, dataclasses.replace(base.cfg, n_layers=LM_TRAIN_LAYERS),
        base.opt_cfg, shapes={"train": LMShape("train", seq, 1)})
    return decode, train


def host_calibration_costs(root: str):
    """Phase 5k's four arms costed in a pool worker, each on a
    one-position mesh of a meta position (float32 products in full
    float32, as on the card).  Returns {arm: predicted figures}."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch

    from repro_torch.core import distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, 1), ("data", "model"),
                     devices=[torch.device("meta")])
    decode, train = calibration_bundles()
    n_u, n_v, rows = CAL_CD
    costs = {
        "A": dist.lower_cd_sweep(mesh, n_u=n_u, n_v=n_v, peel_rows=rows),
        "B": dist.lower_fd_stack(mesh, n_subsets=CAL_FD[0], rows=CAL_FD[1],
                                 cols=CAL_FD[2]),
        "C": dryrun.cost_step(decode, "decode", mesh),
        "D": dryrun.cost_step(train, "train", mesh),
    }
    out = {}
    for arm, c in costs.items():
        r = dryrun.roofline_of(c, chips=1)
        out[arm] = dict(args=int(c.args), peak=float(c.peak),
                        flops=r.flops, units=r.flops_by_unit,
                        t_compute=r.t_compute, t_memory=r.t_memory,
                        t_bound=r.t_bound, bottleneck=r.bottleneck)
    return out


def decode_step_bytes(weights: float, per_pos: float, attended: int,
                      logit_bytes: float) -> float:
    """Phase 5h's reckoning of what a decode step must move: the weights
    (less the embedding table's unread rows), the ``attended`` cache
    positions read and the one written, and the logits."""
    return weights + per_pos * (attended + 1) + logit_bytes


def cal_ms(torch, fn, reps: int = CAL_REPS) -> float:
    """Median device ms of ``fn`` over ``reps`` calls after one warm-up,
    each call between CUDA events."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    return sorted(ms)[len(ms) // 2]


def calibrate(torch, ops, launches, arm, pred, make):
    """One calibration arm: ``make()`` puts the arm's arguments on the
    card and returns the step; the bytes it made resident, the step's
    peak (both from the same base) and its median ms are held against the
    prediction ``pred``.  Returns (the measured figures, the step)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    run = make()
    gc.collect()
    torch.cuda.synchronize()
    args = torch.cuda.memory_allocated() - base
    out, _, peak, _ = counted(torch, ops, launches, f"dryrun_{arm}", run)
    peak -= base
    del out
    ms = cal_ms(torch, run)
    got = dict(args=args, peak=peak, ms=ms)
    log(f"dryrun calibration {arm}: arguments predicted {pred['args']} | "
        f"made resident {args} ({pred['args'] / max(args, 1):.4f}x); peak "
        f"predicted {pred['peak']:.0f} | max_memory_allocated {peak} "
        f"({pred['peak'] / max(peak, 1):.4f}x); t_compute "
        f"{pred['t_compute'] * 1e3:.4f} ms {pred['units']}, t_memory "
        f"{pred['t_memory'] * 1e3:.4f} ms, t_bound {pred['t_bound'] * 1e3:.4f}"
        f" ms ({pred['bottleneck']}); measured {ms:.4f} ms (median of "
        f"{CAL_REPS}, CUDA events) = {ms / (pred['t_bound'] * 1e3):.3f} x "
        f"t_bound")
    if abs(pred["args"] - args) > CAL_ARGS_TOL * args:
        raise AssertionError(f"dryrun {arm}: predicted arguments "
                             f"{pred['args']} vs {args} resident")
    if abs(pred["peak"] - peak) > CAL_PEAK_TOL * peak:
        raise AssertionError(f"dryrun {arm}: predicted peak {pred['peak']}"
                             f" vs max_memory_allocated {peak}")
    if ms < pred["t_compute"] * 1e3:
        raise AssertionError(f"dryrun {arm}: {ms} ms under t_compute "
                             f"{pred['t_compute'] * 1e3} ms")
    return got, run


def dryrun_phase(torch, np, dev, launches, ops, bfly, bsp, host):
    """Phase 5k: the dry run (``repro_torch.launch.dryrun``).

    a. The whole dry run, from the pool worker started before phase 2:
       every record ``ok``, one line per cell, the worker's wall time.
    b. Four calibration arms on the card, each costed by the same
       functions on a one-position meta mesh (``host_calibration_costs``):
       A, one CD sweep of ``_CDShards`` on a (1, 1) mesh of the card
       (kernel 1's peel body); B, ``fd_stack_step`` (kernel 3, then the
       sequential peel); C, minitron-8b's decode step; D, its 4-layer
       train step.  Kernels 1 and 3 are counted and held ``torch.equal``
       to their plain versions on the arguments the arm handed them."""
    from repro_torch.core import distributed as dist
    from repro_torch.data import synthetic as syn
    from repro_torch.launch.dryrun import all_cells
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_cache
    from repro_torch.train.train_step import init_train_state

    # ---- a. the whole dry run ----
    t0 = time.perf_counter()
    rc, wall, records = host[("dryrun",)].result()
    waited = time.perf_counter() - t0
    bad = [(r["arch"], r["shape"], r["mesh"]) for r in records
           if not r.get("ok")]
    want = 2 * len(all_cells())
    for r in records:
        if not r.get("ok"):
            continue
        rf, mem = r["roofline"], r["memory_analysis"]
        log(f"dryrun {r['arch']:20s} {r['shape']:14s} {r['mesh']:8s} "
            f"t_comp {rf['t_compute_s'] * 1e3:11.3f} ms t_mem "
            f"{rf['t_memory_s'] * 1e3:11.3f} ms t_coll "
            f"{rf['t_collective_s'] * 1e3:10.3f} ms {rf['bottleneck']:10s} "
            f"args/position {mem['argument_size_in_bytes']} "
            f"({r['lower_compile_s']:.1f} s)")
    log(f"dryrun: {len(records)} records of {want}, exit code {rc}, worker "
        f"wall {wall:.1f} s (waited {waited:.1f} s for it here)")
    if rc != 0 or bad or len(records) != want:
        raise AssertionError(f"dryrun: exit code {rc}, {len(records)} "
                             f"records of {want}, failed {bad}")

    # ---- b. calibration on the card ----
    pred = host[("calibration",)].result()
    mesh = make_mesh((1, 1), ("data", "model"), devices=[dev])
    gen = torch.Generator(device=dev).manual_seed(0)
    got = {}

    def arm_a():
        n_u, n_v, rows = CAL_CD
        a = (torch.rand((n_u, n_v), generator=gen, device=dev)
             < CAL_CD_DENSITY).to(torch.float32)
        sh = dist._CDShards(mesh, a)
        del a
        sup = sh.split(torch.rand(n_u, generator=gen, device=dev) * 1e3,
                       torch.float32)
        alv = sh.split(torch.ones(n_u, dtype=torch.bool, device=dev),
                       torch.bool)
        peel = torch.randperm(n_u, generator=gen, device=dev)[:rows]
        peel = peel.sort().values.to(torch.int32)
        valid = torch.ones(rows, dtype=torch.float32, device=dev)
        return lambda: sh.sweep(sup, alv, peel, valid, 0.0, 16384)

    def arm_b():
        g, m, n_v = CAL_FD
        a = (torch.rand((g, m, n_v), generator=gen, device=dev)
             < CAL_FD_DENSITY).to(torch.float32)
        sup0 = torch.rand((g, m), generator=gen, device=dev) * 1e6
        n_members = torch.full((g,), m, dtype=torch.int32, device=dev)
        lo = torch.zeros(g, dtype=torch.float32, device=dev)
        return lambda: dist.fd_stack_step(a, sup0, n_members, lo)

    for arm, make, targets in (("A", arm_a, [(bfly, "butterfly_update")]),
                               ("B", arm_b, [(bsp, "b2_stack")])):
        got[arm], run = calibrate(torch, ops, launches, arm, pred[arm],
                                  make)
        # one more call, its kernel's arguments kept (clones: outside the
        # measured calls), for the comparison with the plain version
        seen, restore = first_calls(torch, targets)
        try:
            run()
        finally:
            restore()
        del run
        (fname, (args, kw)), = seen.items()
        if fname == "butterfly_update":
            k_out = bfly.butterfly_update(*args, **kw)
            p_out = bfly.butterfly_update_plain(*args)
        else:
            k_out = bsp.b2_stack(*args, **kw)
            p_out = bsp.b2_stack_plain(*args[:3], blocks=kw["blocks"])
        if not torch.equal(k_out, p_out):
            raise AssertionError(f"dryrun {arm}: {fname} differs from its "
                                 "plain version")
        ran = {k: v for k, v in launches[f"dryrun_{arm}"].items() if v}
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        log(f"dryrun calibration {arm}: {fname} torch.equal to its plain "
            f"version on the arm's first call {shapes}; launches {ran}")
        del seen, args, k_out, p_out
        gc.collect()
        torch.cuda.empty_cache()

    decode, train = calibration_bundles()
    cfg = decode.cfg
    max_len = decode.shapes["decode"].seq_len
    keep = {}

    def arm_c():
        keep["params"] = params = decode.init_params(gen)
        cache = init_cache(cfg, LM_SLOTS, max_len, device=dev)
        cache["len"] = max_len - 1
        tok = torch.randint(0, cfg.vocab, (LM_SLOTS,), generator=gen,
                            device=dev, dtype=torch.int32)
        step = decode.step_for("decode")[1]
        return lambda: step(params, {"token": tok, "cache": cache})

    got["C"], _ = calibrate(torch, ops, launches, "C", pred["C"], arm_c)
    params = keep.pop("params")
    p_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    embed_bytes = params.embed.numel() * params.embed.element_size()
    del params
    weights = p_bytes if cfg.tie_embeddings else (
        p_bytes - embed_bytes + LM_SLOTS * embed_bytes // cfg.vocab)
    cache_bytes = sum(v.numel() * v.element_size() for v in init_cache(
        cfg, LM_SLOTS, max_len, device="meta").values() if torch.is_tensor(v))
    logit_bytes = LM_SLOTS * cfg.vocab * torch.finfo(cfg.param_dtype).bits // 8
    reckoned = decode_step_bytes(weights, cache_bytes / max_len, max_len,
                                 logit_bytes) / HBM_BYTES_PER_S
    log(f"dryrun calibration C: t_memory {pred['C']['t_memory'] * 1e3:.4f} ms"
        f" vs phase 5h's bound at the same shapes {reckoned * 1e3:.4f} ms "
        f"({pred['C']['t_memory'] / reckoned:.4f}x)")
    if abs(pred["C"]["t_memory"] - reckoned) > CAL_DECODE_TOL * reckoned:
        raise AssertionError(f"dryrun C: t_memory {pred['C']['t_memory']} "
                             f"vs phase 5h's bound {reckoned}")
    gc.collect()
    torch.cuda.empty_cache()

    def arm_d():
        params = train.init_params(gen)
        state = init_train_state(params, train.opt_cfg)
        seq = train.shapes["train"].seq_len
        batch = syn.lm_train_batch(train.cfg.vocab, 1, seq, seed=0,
                                   device=dev)
        step = train.step_for("train")[1]
        return lambda: step(state, batch)

    got["D"], _ = calibrate(torch, ops, launches, "D", pred["D"], arm_d)
    gc.collect()
    torch.cuda.empty_cache()
    log("dryrun calibration table (arm, measured ms / t_bound, predicted / "
        "measured peak, predicted / resident arguments): " + json.dumps({
            arm: [round(g["ms"] / (pred[arm]["t_bound"] * 1e3), 4),
                  round(pred[arm]["peak"] / max(g["peak"], 1), 4),
                  round(pred[arm]["args"] / max(g["args"], 1), 4)]
            for arm, g in got.items()}))


def main() -> int:
    t_start = time.perf_counter()
    import torch

    # ---- 1. card ------------------------------------------------------ #
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.core.graph import BipartiteGraph, powerlaw_bipartite

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

    # the host oracles of phases 5c and 5d (the level peel of sp_mid's
    # edges takes about a minute): worker processes started now, read
    # when their phase needs them, shut down on the way out
    g_full = powerlaw_bipartite(FULL["n_u"], FULL["n_v"], FULL["m"],
                                seed=FULL["seed"])
    sp_mid = powerlaw_bipartite(*SP_MID[:3], seed=SP_MID[3])
    mutations = {frac: mutate(np, BipartiteGraph, g_full, frac, seed=k)
                 for k, frac in enumerate(REFRESH_FRACS)}
    wing_mutation = mutate(np, BipartiteGraph, sp_mid, WING_REFRESH_FRAC,
                           seed=7)

    def arrays(g):
        return g.n_u, g.n_v, g.edges_u, g.edges_v

    # two more for phase 5k's dry run and the calibration arms' costs,
    # submitted first: their host time overlaps the card phases
    pool = ProcessPoolExecutor(max_workers=5,
                               mp_context=multiprocessing.get_context("spawn"))
    root = str(Path(__file__).resolve().parent)
    try:
        oracles = {("dryrun",): pool.submit(host_dryrun, root,
                                            str(Path(root) / DRYRUN_OUT)),
                   ("calibration",): pool.submit(host_calibration_costs,
                                                 root)}
        oracles.update({
                   ("wing", 0.0): pool.submit(exact_psi, *arrays(sp_mid)),
                   ("wing", WING_REFRESH_FRAC): pool.submit(
                       exact_psi, *arrays(wing_mutation[0]))})
        for frac in REFRESH_FRACS:
            oracles[("tip", frac)] = pool.submit(
                exact_theta_of, *arrays(mutations[frac][0]))
        # phase 5i's host build of the GraphSAGE cell's neighbour table
        cell = GNN_SHAPES["minibatch_lg"]
        oracles[("nbr_table",)] = pool.submit(
            host_nbr_table, cell.n_nodes, cell.n_edges, GNN_GRAPH_SEED,
            GNN_MAX_DEG)
        return run_phases(torch, np, dev, name, g_full, sp_mid, mutations,
                          wing_mutation, oracles, t_start)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run_phases(torch, np, dev, name, g_full, sp_mid, mutations,
               wing_mutation, oracles, t_start) -> int:
    """Phases 2-7 (module docstring)."""
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
    want_fleet = executor_phase(
        torch, np, dev, g_full, want, fleet, launches, EngineConfig,
        Executor, exact_theta, bup_oracle, ops, small, powerlaw_bipartite)

    # ---- 5c. the incremental re-peel at full size --------------------- #
    refresh_rows = refresh_phase(
        torch, np, dev, g_full, want, launches, oracles, EngineConfig,
        Executor, ops, measure, mutations)

    # ---- 5d. the edge axis (wing) on sp_mid ---------------------------- #
    edge_rows, wing_refresh = wing_phase(
        torch, np, dev, g_full, launches, oracles, EngineConfig, Executor,
        ops, sp_mid, wing_mutation)

    # ---- 5e. the decomposition service --------------------------------- #
    t0 = time.perf_counter()
    service_phase(torch, np, dev, g_full, want, sp_mid, fleet, want_fleet,
                  launches, oracles, mutations, wing_mutation, refresh_rows,
                  wing_refresh, EngineConfig, BipartiteGraph, ops)
    log(f"service: phase 5e in {time.perf_counter() - t0:.1f} s")

    # ---- 5f. the distributed engine on a mesh of one card ------------- #
    t0 = time.perf_counter()
    mesh_phase(torch, np, dev, g_full, want, launches, full_stats,
               full_walls, paths, EngineConfig, Executor, DeviceGraph, ops)
    log(f"mesh: phase 5f in {time.perf_counter() - t0:.1f} s")

    # ---- 5g. the training substrate and the recsys path --------------- #
    t0 = time.perf_counter()
    recsys_phase(torch, np, dev, launches, ops, bfly, bsp, measure)
    log(f"recsys: phase 5g in {time.perf_counter() - t0:.1f} s")

    # ---- 5h. the language-model serving path --------------------------- #
    t0 = time.perf_counter()
    lm_phase(torch, np, dev, launches, ops)
    log(f"lm: phase 5h in {time.perf_counter() - t0:.1f} s")

    # ---- 5i. the training path of the GNN family and the LM ----------- #
    t0 = time.perf_counter()
    gnn_lm_train_phase(torch, np, dev, launches, ops, oracles)
    log(f"train: phase 5i in {time.perf_counter() - t0:.1f} s")

    # ---- 5j. the sharding layer --------------------------------------- #
    t0 = time.perf_counter()
    sharding_phase(torch, np, dev, launches, ops)
    log(f"sharding: phase 5j in {time.perf_counter() - t0:.1f} s")

    # ---- 5k. the dry run and its calibration on the card -------------- #
    t0 = time.perf_counter()
    dryrun_phase(torch, np, dev, launches, ops, bfly, bsp, oracles)
    log(f"dryrun: phase 5k in {time.perf_counter() - t0:.1f} s")

    # ---- 6. crossover: staircase + graph against tiled ---------------- #
    # the full-size graph's walls are phase 5's timed runs: the kernels and
    # the allocator are warm by then (phases 3-4), and a second run there
    # measured no faster (PERF.md)
    ladder = {"sp_mid": sp_mid,
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
        ("butterfly_update[peel]", "butterfly_update[peel_refresh]", *k1),
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
        ("butterfly_update_batched[peel]",
         "butterfly_update_batched[recsys_count]",
         "src/repro_torch/kernels/csrc/butterfly_sparse.cu",
         "src/repro/kernels/butterfly.py:225"),
        ("b2_stack[pairs]", "b2_stack[recsys_b2]",
         "src/repro_torch/kernels/csrc/b2_stack.cu",
         "src/repro/kernels/butterfly_sparse.py:420"),
        ("butterfly_update_sparse[count]", "butterfly_update_sparse[count]",
         count_cu, k4[1]),
        ("butterfly_update_sparse[peel]", "butterfly_update_sparse[peel]",
         *k4),
        ("butterfly_update_sparse[peel]",
         "butterfly_update_sparse[peel_refresh]", *k4),
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
    log("edge closed form (not a kernel: no Pallas body in the reference; "
        "two float64 torch.matmul): " + json.dumps(edge_rows))
    log(f"script: {time.perf_counter() - t_start:.1f} s from its start to "
        "the kernel list")
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
