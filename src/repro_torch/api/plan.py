"""Planning stage: ``Planner.plan(graph) -> ExecutionPlan`` (port of
``repro.api.plan``, tip workload).

The plan surfaces RECEIPT's statically schedulable structure BEFORE
execution, as pure host work on the edge list:

* what will run — CD dispatch mode and partition budget, FD mode and
  update policy, the resolved kernel backend and its route label;
* at what shapes — the bucketed device-matrix shape (``rows_pad`` x
  ``cols_pad``), the initial CD peel width the reference would size, and
  a wedge-equipartition ESTIMATE of the FD shape groups and their padding
  waste (the exact groups depend on the CD result);
* at what cost — a padded-bytes device-memory estimate, checked against
  ``EngineConfig.memory_budget_bytes`` (admission control: downshift the
  partition count, route tiled, or raise ``PlanInfeasibleError``);
* which representation — dense or tiled, by the reference's crossover
  rule, memory admission overriding it.

``ExecutionPlan.signature`` keys the Executor's cache.  The ``measured``
slot is the feedback channel the engine writes back through (its
``plan=`` kwarg).  Which hooks change what the engine builds, and which
only record:

* changes a shape — ``fd_width_hint`` sets an FD stack's gather width to
  the one an earlier same-signature run measured (``note_fd_level``);
* recording only — ``quantize_dim`` (``dgm_rows``/``dgm_cols`` in
  ``DeviceGraph``; ``fd_rows``/``fd_cols``/``fd_l1``/``fd_groups`` in
  ``fd.build_level_stack``; ``tiled_rows``/``tiled_cols``/``tiled_slots``
  in ``tiled.build_tiled``) records the size each build chose and hands
  it back unchanged.  The reference pads these shapes up to ones an
  earlier run compiled (and the tiled slot count to a bucket even on a
  cold plan) so that its jit cache hits; the port has no jit cache, so
  padding would only add work.  ``note_cd_peel_width`` keeps the widest
  CD gather of the run: the reference pins its CD peel buffer to it (its
  ``cd_peel_width_hint``); the port sizes every CD gather to its peel
  set, so nothing reads the width back, and ``cd_peel_width0`` is the
  reference's planned width, kept for parity.

**Device memory** (``padded_bytes``) is the port's own count of what a
run holds at its peak, a formula in the plan's shapes
(``_dense_cd_bytes``, ``fd.fd_state_bytes`` + ``fd.fd_update_bytes``,
``_tiled_bytes``,
``_wing_member_bytes``, ``_wing_closed_form_bytes``): the matrices the
engine keeps, the kernels' scratch (the count body's s8 copy, the peel
body's gathered rows, kernel 3's s8 stack copy, kernel 6's window
scratch) and the largest temporaries, checked against
``torch.cuda.max_memory_allocated`` above what was resident, on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  With a mesh
(``plan(graph, mesh=...)``: ``mesh_shards``) the FD count is that of the
LPT-padded stacks of the shards that share the fullest device, and a
sharded plan never routes tiled on its own, as the reference's.  The FD
count is a prediction of the engine's subsets, which the host cannot know
before counting; the FD phase keeps within ``padded_bytes`` all the same
(``fd._pipeline``: a shape group whose stacks would not fit launches in
parts), so only one subset whose own stacks exceed the plan can go over
it.  What
the process holds for its life is not the run's: the CUDA context, and
cuBLAS's workspace (32 MiB per stream on an H100, allocated at the
process's first matrix product and kept).  It differs by design from
the reference's, which counts the dense matrix, one peel buffer and the
FD stacks (or one wing stack member per partition); the admission rules
are the reference's (downshift P, route tiled, reject), so an outcome
that follows from the bytes may differ too.

There is no jit cache here, so the reuse is of plans and the FD gather
widths, not of compiled programs.  The plan's host-sync bound differs by design:
the port's CD loops read the peel-set size once per sweep (and once per
HUC choice), so ``cd_host_syncs_bound`` is ``None`` and ``describe()``
says O(sweeps), where the reference bounds the graph dispatch by 2.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.engine.fd import (ROW_STATE_BYTES, WIDE_ROW_VECTORS,
                              fd_state_bytes, fd_update_bytes)
from ..core.engine.peel_loop import ReceiptConfig, bucket, cd_gather_width
from ..core.graph import BipartiteGraph
from ..core.scheduler import lpt_shard_plan
from ..kernels import butterfly as kbfly
from ..kernels import butterfly_tiled as ktiled
from ..kernels import ops as kops
from ..launch.mesh import check_mesh
from ..utils.spans import span
from .config import EngineConfig
from .errors import PlanInfeasibleError

__all__ = ["ExecutionPlan", "PlanMeasurements", "Planner",
           "TILED_OCCUPANCY_CROSSOVER", "TILED_MIN_DENSE_CELLS"]

# ---------------------------------------------------------------------- #
# dense -> tiled routing crossover (representation="auto")
#
# The reference's constants, kept for plan parity: its tiled wedge kernel
# visits n_row_tiles * n_slots tile pairs where the dense grid visits
# n_row_tiles * n_col_tiles * n_row_tiles, so the work ratio is the
# tile-grid occupancy.  They were measured on the reference's CPU backend
# (xla), where tiled won at occupancy 0.025 and 2^25 dense cells; routing
# fires at occupancy <= 0.03 AND >= 2^24 padded dense cells.  The H100
# crossover is still open: the port's tiled path lost on every graph
# measured so far, all at occupancy 0.53-0.76 (PERF.md), which this rule
# keeps dense anyway.  Memory admission overrides the speed rule.
# ---------------------------------------------------------------------- #
TILED_OCCUPANCY_CROSSOVER = 0.03
TILED_MIN_DENSE_CELLS = 1 << 24


# ---------------------------------------------------------------------- #
# device-memory model (bytes a run holds at its peak; module docstring)
# ---------------------------------------------------------------------- #
_F32_BYTES = 4
_F64_BYTES = 8
# per-row and per-column bytes of the sweep state (supports, masks, theta,
# ids, extents, column sums and the like: the FD stacks' own model,
# ``fd.fd_state_bytes``, whose supports, theta and deltas are float64),
# and per-edge-slot bytes of the wing state
# (supports, masks, theta, int64 endpoints, the closed form's float64
# gathers)
_ROW_STATE_BYTES = ROW_STATE_BYTES
# the tiled route keeps float32 supports and theta (kernel 6)
_F32_ROW_STATE_BYTES = ROW_STATE_BYTES - WIDE_ROW_VECTORS * (_F64_BYTES
                                                             - _F32_BYTES)
_COL_STATE_BYTES = 32
_EDGE_STATE_BYTES = 96


def _dense_cd_bytes(rows_pad: int, cols_pad: int, block_rows: int,
                    graph_dispatch: bool) -> int:
    """Peak of the dense CD phase: the (R, C) f32 matrix and, at most one
    at a time, the count body's s8 copy (counting, HUC recounts), a peel
    update's gather of ``cd_gather_width`` rows and the peel body's
    scratch, or — graph dispatch — the on-device DGM compaction, which
    holds the old and the compacted matrix, then the compacted one and
    its ``min(du, dv)`` product."""
    d = _F32_BYTES * rows_pad * cols_pad
    w0 = cd_gather_width(rows_pad, block_rows)
    peak = max(kbfly.count_scratch_bytes(rows_pad, cols_pad),
               _F32_BYTES * w0 * cols_pad
               + kbfly.peel_scratch_bytes(w0, cols_pad))
    if graph_dispatch:
        peak = max(peak, d)
    return (d + peak + _ROW_STATE_BYTES * rows_pad
            + _COL_STATE_BYTES * cols_pad)


def _mesh_fd_slots(group_weights: List[List[float]],
                   n_shards: int) -> List[int]:
    """Slots per shard of each FD shape group on a mesh of ``n_shards``:
    the engine's own layout (``scheduler.lpt_shard_plan``) of each group's
    task weights, in the engine's group order, with the shard loads
    carried across groups as ``fd._run_level_groups_mesh`` carries them.
    LPT can give one shard more than ``ceil(n_g / n_shards)`` tasks: a
    heavy task (or a load carried from an earlier group) leaves the light
    ones to fewer shards."""
    loads = np.zeros(n_shards, np.float64)
    out = []
    for weights in group_weights:
        slots, per_shard = lpt_shard_plan(weights, n_shards, list(loads))
        lay = np.asarray(slots).reshape(n_shards, per_shard)
        w = np.asarray(weights, np.float64)
        loads = loads + np.where(lay >= 0, w[np.maximum(lay, 0)], 0.0).sum(1)
        out.append(per_shard)
    return out


def _predict_fd_subsets(g: BipartiteGraph, p: int, levels: int = 1
                         ) -> List[Tuple[int, int, float]]:
    """The engine's FD subsets as the host can predict them before
    counting: ``(survivor rows, touched columns, wedge mass)`` each.

    The engine cuts its subsets by support (``cd.find_hi_np``: rows in
    ascending support until the cumulative wedge count reaches the
    remaining mass over the subsets left, then every row of the support
    reached, the next target scaled down by the mass a subset overshot
    it by; the last subset takes the rest), and the host pre-peel
    (``fd.pre_peel_tasks``) drains each subset's lowest ``levels``
    support levels before a stack is built.  Without the counts, the
    support order is a static proxy: rows with no butterfly at all
    first (a row of degree <= 1, or one no wedge leaves, has support 0:
    one level, which the first subset takes whole), then the rest by
    wedge count, equal counts as one level.  A subset's survivors are
    its members less those at its ``levels`` lowest proxy keys; its
    columns are the ones all its members touch
    (``BipartiteGraph.induced_on_u``)."""
    if g.n_u == 0:
        return []
    w = g.wedge_counts_u().astype(np.float64)
    if float(w.sum()) <= 0:
        return []
    du = np.bincount(g.edges_u, minlength=g.n_u)
    zero = (du <= 1) | (w <= 0)
    key = np.where(zero, -1.0, w)           # the support proxy
    order = np.argsort(key, kind="stable")
    ks, cum = key[order], np.cumsum(w[order])
    subset_of = np.empty(g.n_u, np.int64)
    start, i, done, scale = 0, 0, 0.0, 1.0
    while start < g.n_u:
        if i >= p - 1:
            end = g.n_u                     # the catch-all subset
        else:
            tgt = max((cum[-1] - done) / (p - i) * scale, 1.0)
            at = min(int(np.searchsorted(cum, done + tgt)), g.n_u - 1)
            at = max(at, start)
            end = int(np.searchsorted(ks, ks[at], side="right"))
            covered = float(cum[end - 1]) - done
            if covered > 0:                 # the engine's target feedback
                scale = min(1.0, tgt / covered)
        subset_of[order[start:end]] = i
        done = float(cum[end - 1])
        start, i = end, i + 1
    n_v = max(g.n_v, 1)
    cells = np.unique(subset_of[g.edges_u] * n_v + g.edges_v)
    n_cols = np.bincount(cells // n_v, minlength=i)
    # the pre-peel drains each subset's lowest ``levels`` support levels
    # (``fd_prepeel_levels``): here its lowest distinct proxy keys
    drained = np.zeros(g.n_u, bool)
    for j in range(i):
        rows = np.where(subset_of == j)[0]
        keys = np.unique(key[rows])[:levels]
        drained[rows] = np.isin(key[rows], keys)
    surv = np.bincount(subset_of[~drained], minlength=i)
    wedges = np.bincount(subset_of, weights=w, minlength=i)
    return [(int(s), int(c), float(x))
            for s, c, x in zip(surv, n_cols, wedges)]


def _tiled_bytes(n_tiles: int, br: int, bc: int, n_rt: int, n_ct: int,
                 rows_pad: int, cols_pad: int) -> int:
    """Peak of the tiled route: one tile payload (a rebuild drops the old
    list before uploading the new one), kernel 6's window scratch (its
    count launch, every row with mass, capped at the payload's size) or
    the liveness pass's bool copy, the slot lists, and the per-slot
    temporaries of the column sums and the regather."""
    payload = _F32_BYTES * n_tiles * br * bc
    scratch = min(ktiled.peel_scratch_bytes(rows_pad, n_ct, bc), payload)
    lists = _F32_BYTES * (3 * n_tiles + n_rt + 1 + n_rt * n_ct)
    return int(payload + max(scratch, payload // 4) + lists
               + 3 * _F32_BYTES * n_tiles * (br + bc)
               + _F32_ROW_STATE_BYTES * rows_pad
               + _COL_STATE_BYTES * cols_pad)


def _wing_member_bytes(rows_pad: int, cols_pad: int, m_pad: int) -> int:
    """One (R, C) member of the wing engine's matrix or FD stack on the
    card: the f32 matrix and its edge-slot state."""
    return _F32_BYTES * rows_pad * cols_pad + _EDGE_STATE_BYTES * m_pad


def _wing_closed_form_bytes(rows_pad: int, cols_pad: int) -> int:
    """The closed form's float64 temporaries, one member at a time: the
    matrix, ``A^T A`` and ``A (A^T A)``."""
    return _F64_BYTES * (2 * rows_pad * cols_pad + cols_pad * cols_pad)


@dataclasses.dataclass
class PlanMeasurements:
    """Execution feedback attached to a plan (and folded into the
    executor's cache entry for the plan's signature).

    ``cd_peel_width`` — the widest CD gather (rows) of the runs so far
    (recorded only: see the module docstring).

    ``fd_level_widths`` — per stacked-shape ``(mm, cc)``: the gather width
    to reuse at that stack shape (the width a run used when it sufficed,
    the largest level measured when the mask-form update fired).

    ``observed_dims`` — per shape hook: the sizes this run built
    (recorded only: see the module docstring).
    """

    cd_peel_width: Optional[int] = None
    fd_level_widths: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict)
    observed_dims: Dict[str, set] = dataclasses.field(default_factory=dict)
    runs: int = 0


@dataclasses.dataclass
class ExecutionPlan:
    """What a decomposition WILL do, inspectable before it runs.

    Static fields describe the ingested graph and the derived dispatch
    structure; ``est_*`` fields are pre-execution estimates; ``measured``
    carries execution feedback (``PlanMeasurements``).
    """

    signature: Tuple                 # the Executor's cache key (hashable)
    side: str
    n_u: int                         # peeled side (post side-selection)
    n_v: int
    m: int
    backend: str                     # resolved (never None)
    kernel_route: str                # human-readable route label
    kernel_blocks: Tuple[int, int, int]
    cd_dispatch: str
    num_partitions: int
    rows_pad: int                    # bucketed device-matrix shape —
    cols_pad: int                    # the shape half of the signature
    cd_peel_width0: int              # the reference's initial CD width
    cd_host_syncs_bound: Optional[int]   # None: O(sweeps) in the port
    fd_mode: str
    fd_update_policy: str            # "auto" | "b2" | "kernel"
    est_fd_groups: List[Dict[str, int]]   # wedge-equipartition ESTIMATE
    est_fd_padding_waste: float
    mesh_shards: int                 # 0 = single device (always here)
    degree_sort: bool
    device_loop: bool
    padded_bytes: int                # device-memory estimate
    workload: str = "tip"
    m_pad: int = 0                   # edge slots (wing plans; 0 here)
    representation: str = "dense"    # resolved: "dense" | "tiled"
    cost_model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    memory_budget_bytes: Optional[int] = None   # admission-control budget
    degraded_from_partitions: Optional[int] = None
    #                                # the config's partition count when
    #                                # admission control downshifted it
    measured: PlanMeasurements = dataclasses.field(
        default_factory=PlanMeasurements)

    # ------------------------------------------------------------------ #
    # engine feedback surface (read and written by the engine's plan=)
    # ------------------------------------------------------------------ #
    def note_cd_peel_width(self, width: int) -> None:
        cur = self.measured.cd_peel_width or 0
        self.measured.cd_peel_width = max(cur, int(width))

    def fd_width_hint(self, shape: Tuple[int, int]) -> Optional[int]:
        return self.measured.fd_level_widths.get(tuple(shape))

    def note_fd_level(self, shape: Tuple[int, int], level: int,
                      width_used: int) -> None:
        """Record the gather width to reuse at this stack shape: the
        width this run used when it sufficed, the measured level when
        the mask-form update fired."""
        shape = tuple(shape)
        level, width_used = int(level), int(width_used)
        want = width_used if level <= width_used else level
        cur = self.measured.fd_level_widths.get(shape, 1)
        self.measured.fd_level_widths[shape] = max(cur, want, 1)

    def quantize_dim(self, name: str, value: int) -> int:
        """The reference's shape hook, recording only here: note the size
        a build chose under ``name`` and return it unchanged (module
        docstring)."""
        value = int(value)
        self.measured.observed_dims.setdefault(name, set()).add(value)
        return value

    # ------------------------------------------------------------------ #
    # inspection
    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["signature"] = list(map(str, self.signature))
        d["measured"] = {
            "cd_peel_width": self.measured.cd_peel_width,
            "fd_level_widths": {f"{k[0]}x{k[1]}": v for k, v in
                                self.measured.fd_level_widths.items()},
            "runs": self.measured.runs,
        }
        return d

    def describe(self) -> str:
        """Terse human-readable plan summary."""
        est = ", ".join(
            f"{g['count']}x({g['rows']}x{g['cols']})"
            for g in self.est_fd_groups) or "none"
        admit = ""
        if self.degraded_from_partitions is not None:
            admit = (f", admission-degraded from "
                     f"P={self.degraded_from_partitions} under "
                     f"{(self.memory_budget_bytes or 0) / 2**20:.1f} MiB")
        occ = self.cost_model.get("tile_occupancy")
        rep = self.representation
        if occ is not None:
            rep += f" (occupancy {occ:.4f})"
        syncs = ("O(sweeps): one read per sweep, one per HUC choice"
                 if self.cd_host_syncs_bound is None
                 else f"<= {self.cd_host_syncs_bound}")
        return (
            f"ExecutionPlan[{self.side}]: |U|={self.n_u} |V|={self.n_v} "
            f"m={self.m}\n"
            f"  representation: {rep}\n"
            f"  device matrix : {self.rows_pad} x {self.cols_pad} "
            f"(~{self.padded_bytes / 2**20:.1f} MiB padded{admit})\n"
            f"  kernel route  : {self.kernel_route}, blocks="
            f"{self.kernel_blocks}\n"
            f"  CD            : dispatch={self.cd_dispatch!r}, "
            f"P={self.num_partitions}, host syncs {syncs}\n"
            f"  FD            : mode={self.fd_mode!r}, "
            f"update={self.fd_update_policy!r}, est groups: {est} "
            f"(est padding waste {self.est_fd_padding_waste:.0%})\n"
            f"  measured      : cd_peel_width="
            f"{self.measured.cd_peel_width}, "
            f"{len(self.measured.fd_level_widths)} FD width(s), "
            f"runs={self.measured.runs}"
        )


class Planner:
    """Derives an ``ExecutionPlan`` from a graph and a config — pure host
    preprocessing, no device work.

    Accepts an ``EngineConfig`` (the strict service surface) or a legacy
    ``ReceiptConfig`` + ``side`` (the facade's currency — kept permissive
    so A/B configurations the service layer rejects still plan and run).
    ``device`` resolves a ``None`` backend (the card's ``"cuda"`` when no
    device is given, ``"torch"`` for the CPU); nothing is allocated there.
    """

    def __init__(self, config=None, *, side: Optional[str] = None,
                 device=None):
        if config is None:
            config = EngineConfig() if side is None else EngineConfig(
                side=side)
        if isinstance(config, EngineConfig):
            if side is not None and side != config.side:
                config = dataclasses.replace(config, side=side)
            self.config = config
            self.rcfg = config.to_receipt_config()
            self.side = config.side
            self.workload = config.workload
            self.memory_budget = config.memory_budget_bytes
        elif isinstance(config, ReceiptConfig):
            self.config = None          # legacy currency: no strict view
            self.rcfg = config
            self.side = side or "U"
            self.workload = "tip"
            self.memory_budget = None   # admission control is an
            #                           # EngineConfig knob
        else:
            raise ValueError(
                f"Planner expects an EngineConfig or ReceiptConfig, got "
                f"{type(config).__name__}")
        if self.side not in ("U", "V"):
            raise ValueError(f"side must be 'U' or 'V', got {self.side!r}")
        self.device = None if device is None else torch.device(device)

    # ------------------------------------------------------------------ #
    def plan(self, graph: BipartiteGraph, *, mesh=None) -> ExecutionPlan:
        """The plan of ``graph`` (module docstring), under the span
        ``plan`` (a profiler range only: no run exists yet)."""
        with span("plan"):
            return self._plan(graph, mesh)

    def _plan(self, graph: BipartiteGraph, mesh) -> ExecutionPlan:
        if mesh is not None:
            check_mesh(mesh)
        if not isinstance(graph, BipartiteGraph):
            raise ValueError(
                f"Planner.plan expects a BipartiteGraph (got "
                f"{type(graph).__name__}); ingest edge lists with "
                "BipartiteGraph.from_edges or dense 0/1 matrices with "
                "BipartiteGraph.from_dense")
        graph.validate()
        cfg = self.rcfg
        backend = kops.resolve_backend(cfg.backend, self.device)
        g = graph.transposed() if self.side == "V" else graph
        bi, bj, bk = cfg.kernel_blocks
        mesh_shards = int(mesh.size) if mesh is not None else 0
        if self.workload == "wing":
            return self._plan_wing(g, cfg, backend, mesh_shards)

        # --- ingestion-derived shapes (the DeviceGraph bucket math) ---- #
        dv = g.degrees_v()
        n_cols = max(int((dv >= 2).sum()), 1)   # wedge-capable V columns
        rows_pad = bucket(max(g.n_u, 1), max(bi, bj))
        cols_pad = bucket(n_cols, bk)
        if cfg.peel_width is not None:
            width0 = min(bucket(cfg.peel_width, bj), rows_pad)
        else:
            width0 = cd_gather_width(rows_pad, bj)

        # --- FD shape-group estimate (wedge-mass equipartition) -------- #
        est_groups, est_waste = self._estimate_fd_groups(g, cfg)

        # --- memory estimate (the port's own; module docstring) -------- #
        # the CD phase's peak, then the FD phase's; the CD matrix is gone
        # before FD starts
        fixed_bytes = _dense_cd_bytes(rows_pad, cols_pad, bj,
                                      cfg.cd_dispatch == "graph")
        padded_bytes = max(fixed_bytes,
                           self._estimate_fd_bytes(g, cfg, mesh=mesh))

        # --- representation routing ------------------------------------ #
        # the mesh FD is dense only: a sharded plan never routes tiled on
        # its own
        req_rep = cfg.representation
        tiled_est = self._estimate_tiled(g, cfg)
        dense_cells = rows_pad * cols_pad
        budget = self.memory_budget
        if req_rep == "tiled":
            representation = "tiled"
        elif req_rep == "auto" and mesh_shards == 0 and (
                (budget is not None and fixed_bytes > budget)
                or (tiled_est["tile_occupancy"] <= TILED_OCCUPANCY_CROSSOVER
                    and dense_cells >= TILED_MIN_DENSE_CELLS)):
            representation = "tiled"
        else:
            representation = "dense"
        cost_model = {
            "requested": req_rep,
            "dense_bytes": padded_bytes,
            "dense_fixed_bytes": fixed_bytes,
            "dense_cells": dense_cells,
            "tiled_bytes": tiled_est["tiled_bytes"],
            "n_tiles": tiled_est["n_tiles"],
            "tile_occupancy": tiled_est["tile_occupancy"],
            "tile_blocks": tiled_est["tile_blocks"],
            "occupancy_crossover": TILED_OCCUPANCY_CROSSOVER,
            "min_dense_cells": TILED_MIN_DENSE_CELLS,
        }

        # --- admission control (DESIGN.md §7) -------------------------- #
        # Over-budget plans DEGRADE before they reject: re-partitioning
        # resizes the FD stacks (not monotone in P, so both directions are
        # probed, nearest the requested count first).  Only when the fixed
        # CD footprint alone overflows, or no probed partitioning fits, is
        # the plan infeasible — and an "auto" plan takes the tiled route
        # instead when the tile list fits.
        admitted_p = cfg.num_partitions
        degraded_from = None
        if representation == "tiled":
            padded_bytes = tiled_est["tiled_bytes"]
            est_groups, est_waste = [], 0.0
            if budget is not None and padded_bytes > budget:
                raise PlanInfeasibleError(
                    f"the tiled representation still needs {padded_bytes} "
                    f"bytes ({tiled_est['n_tiles']} nonzero "
                    f"{tiled_est['tile_blocks'][0]}x"
                    f"{tiled_est['tile_blocks'][1]} tiles), over the "
                    f"memory_budget_bytes={budget} admission budget — "
                    "raise the budget or shrink the graph/blocks",
                    dispatch=cfg.cd_dispatch, backend=backend,
                    padded_bytes=padded_bytes, budget=budget)
        elif budget is not None and padded_bytes > budget:
            if fixed_bytes > budget:
                raise PlanInfeasibleError(
                    f"the CD phase alone needs {fixed_bytes} bytes "
                    f"({rows_pad} x {cols_pad} biadjacency, its kernels' "
                    f"scratch and {cd_gather_width(rows_pad, bj)}-row "
                    f"gathers), over the "
                    f"memory_budget_bytes={budget} admission budget — no "
                    "FD downshift can help; raise the budget, shrink the "
                    "graph/blocks, or route representation='tiled'",
                    dispatch=cfg.cd_dispatch, backend=backend,
                    padded_bytes=padded_bytes, budget=budget)
            cands: List[int] = []
            lo_p = hi_p = cfg.num_partitions
            for _ in range(8):                      # bounded probe, near
                lo_p = max(lo_p // 2, 1)            # to far in both
                hi_p *= 2                           # directions
                for q in (lo_p, hi_p):
                    if q != cfg.num_partitions and q not in cands:
                        cands.append(q)
            best = (padded_bytes, admitted_p, est_groups, est_waste)
            found = False
            for p_try in cands:
                groups_try, waste_try = self._estimate_fd_groups(
                    g, cfg, num_partitions=p_try)
                bytes_try = max(fixed_bytes, self._estimate_fd_bytes(
                    g, cfg, num_partitions=p_try, mesh=mesh))
                if bytes_try < best[0]:
                    best = (bytes_try, p_try, groups_try, waste_try)
                if bytes_try <= budget:
                    best = (bytes_try, p_try, groups_try, waste_try)
                    found = True
                    break                           # first fit = nearest
            padded_bytes, admitted_p, est_groups, est_waste = best
            if not found and padded_bytes > budget:
                if (req_rep == "auto" and mesh_shards == 0
                        and tiled_est["tiled_bytes"] <= budget):
                    # no dense partitioning fits — the tile list does
                    representation = "tiled"
                    padded_bytes = tiled_est["tiled_bytes"]
                    admitted_p = cfg.num_partitions
                    est_groups, est_waste = [], 0.0
                else:
                    raise PlanInfeasibleError(
                        f"plan needs {padded_bytes} padded bytes, over the "
                        f"memory_budget_bytes={budget} admission budget even "
                        f"at the best probed partitioning ({admitted_p} "
                        f"partitions; requested {cfg.num_partitions})",
                        dispatch=cfg.cd_dispatch, backend=backend,
                        padded_bytes=padded_bytes, budget=budget)
            if representation == "dense" and admitted_p != cfg.num_partitions:
                degraded_from = cfg.num_partitions

        cfg_items = tuple(sorted(
            (f.name, _freeze(getattr(cfg, f.name)))
            for f in dataclasses.fields(cfg)))
        signature = (rows_pad, cols_pad, self.side, backend, mesh_shards,
                     admitted_p, representation, cfg_items, self.workload)
        return ExecutionPlan(
            signature=signature, workload=self.workload,
            side=self.side, n_u=g.n_u, n_v=g.n_v, m=g.m,
            backend=backend, kernel_route=kops.route_label(backend),
            kernel_blocks=tuple(cfg.kernel_blocks),
            cd_dispatch=cfg.cd_dispatch,
            num_partitions=admitted_p,
            rows_pad=rows_pad, cols_pad=cols_pad,
            cd_peel_width0=width0,
            cd_host_syncs_bound=None,
            fd_mode=cfg.fd_mode, fd_update_policy=cfg.fd_update_mode,
            est_fd_groups=est_groups, est_fd_padding_waste=est_waste,
            mesh_shards=mesh_shards,
            degree_sort=cfg.degree_sort, device_loop=cfg.device_loop,
            padded_bytes=padded_bytes,
            representation=representation,
            cost_model=cost_model,
            memory_budget_bytes=budget,
            degraded_from_partitions=degraded_from,
        )

    # ------------------------------------------------------------------ #
    def _plan_wing(self, g: BipartiteGraph, cfg: ReceiptConfig,
                   backend: str, mesh_shards: int) -> ExecutionPlan:
        """Edge-axis (wing) plan (reference ``_plan_wing``).

        Shapes mirror ``engine.wing.build_edge_state``: the biadjacency
        keeps every ``n_v`` column (the edge axis peels matrix entries),
        the supports live on ``m_pad`` edge slots.  FD is one stack of P
        members of the biadjacency's shape.  Memory counts what the card
        holds: each member's f32 matrix and edge-slot state
        (``_wing_member_bytes``) and, once, the closed form's float64
        temporaries (``_wing_closed_form_bytes``: one member at a time);
        the CD phase holds one member, FD all P, so admission downshifts
        the partition count by the per-member cost before it rejects.
        """
        bi, bj, bk = cfg.kernel_blocks
        rows_pad = bucket(max(g.n_u, 1), max(bi, bj))
        cols_pad = bucket(max(g.n_v, 1), bk)
        m_pad = bucket(max(g.m, 1), bj)
        if cfg.peel_width is not None:
            width0 = min(bucket(cfg.peel_width, bj), m_pad)
        else:
            width0 = min(bucket(max(bj, m_pad // 8), bj), m_pad)

        member = _wing_member_bytes(rows_pad, cols_pad, m_pad)
        temps = _wing_closed_form_bytes(rows_pad, cols_pad)
        fixed_bytes = member + temps        # the CD phase's peak
        budget = self.memory_budget
        admitted_p = max(cfg.num_partitions, 1)
        degraded_from = None
        padded_bytes = member * admitted_p + temps
        if budget is not None and padded_bytes > budget:
            if fixed_bytes > budget:
                raise PlanInfeasibleError(
                    f"the wing device matrix alone needs {fixed_bytes} "
                    f"bytes ({rows_pad} x {cols_pad} biadjacency with its "
                    f"closed form's float64 temporaries, {m_pad} edge "
                    f"slots), over the memory_budget_bytes={budget} "
                    "admission budget — no partition downshift can help; "
                    "raise the budget or shrink the graph/blocks",
                    dispatch=cfg.cd_dispatch, backend=backend,
                    padded_bytes=fixed_bytes, budget=budget)
            degraded_from = cfg.num_partitions
            admitted_p = max(int((budget - temps) // member), 1)
            padded_bytes = member * admitted_p + temps
        est_groups = [dict(rows=rows_pad, cols=cols_pad, count=admitted_p)]
        est_waste = (1.0 - g.m / float(admitted_p * rows_pad * cols_pad)
                     if g.m else 0.0)
        cost_model = {
            "requested": cfg.representation,
            "dense_bytes": padded_bytes,
            "dense_fixed_bytes": fixed_bytes,
            "dense_cells": rows_pad * cols_pad,
            "edge_slots": m_pad,
        }
        cfg_items = tuple(sorted(
            (f.name, _freeze(getattr(cfg, f.name)))
            for f in dataclasses.fields(cfg)))
        signature = (rows_pad, cols_pad, self.side, backend, mesh_shards,
                     admitted_p, "dense", cfg_items, self.workload)
        return ExecutionPlan(
            signature=signature, workload="wing", m_pad=m_pad,
            side=self.side, n_u=g.n_u, n_v=g.n_v, m=g.m,
            backend=backend, kernel_route=kops.route_label(backend),
            kernel_blocks=tuple(cfg.kernel_blocks),
            cd_dispatch=cfg.cd_dispatch,
            num_partitions=admitted_p,
            rows_pad=rows_pad, cols_pad=cols_pad,
            cd_peel_width0=width0,
            cd_host_syncs_bound=None,
            fd_mode=cfg.fd_mode, fd_update_policy="kernel",
            est_fd_groups=est_groups, est_fd_padding_waste=est_waste,
            mesh_shards=mesh_shards,
            degree_sort=False,          # the edge axis never relabels
            device_loop=cfg.device_loop,
            padded_bytes=padded_bytes,
            representation="dense",
            cost_model=cost_model,
            memory_budget_bytes=budget,
            degraded_from_partitions=degraded_from,
        )

    # ------------------------------------------------------------------ #
    def _estimate_tiled(self, g: BipartiteGraph,
                        cfg: ReceiptConfig) -> Dict[str, Any]:
        """Host-side estimate of the tiled representation's footprint,
        mirroring what ``engine.tiled.receipt_tiled`` builds: the DGM
        pre-compaction (degree-<2 V columns drop out), the degree-sort
        relabeling, then the occupied ``block_rows x block_k`` tiles.
        ``tiled_bytes`` is the route's peak (``_tiled_bytes``)."""
        from ..core.engine.tiled import tiled_blocks

        br, bc = tiled_blocks(cfg)
        eu, ev = g.edges_u, g.edges_v
        if len(ev):
            dv = np.bincount(ev, minlength=g.n_v)
            keep = dv[ev] >= 2
            eu, ev = eu[keep], ev[keep]
        n_cols = max(int(np.unique(ev).size), 1) if len(ev) else 1
        if cfg.degree_sort and len(eu):
            du2 = np.bincount(eu, minlength=g.n_u)
            dv2 = np.bincount(ev, minlength=g.n_v)
            inv_u = np.empty(g.n_u, np.int64)
            inv_u[np.argsort(-du2, kind="stable")] = np.arange(g.n_u)
            inv_v = np.empty(g.n_v, np.int64)
            inv_v[np.argsort(-dv2, kind="stable")] = np.arange(g.n_v)
            eu, ev = inv_u[eu], inv_v[ev]
        rows_pad_t = bucket(max(g.n_u, 1), br)
        cols_pad_t = bucket(n_cols, bc)
        n_rt = rows_pad_t // br
        n_ct = cols_pad_t // bc
        if len(eu):
            occupied = np.unique(eu.astype(np.int64) // br * n_ct
                                 + ev.astype(np.int64) // bc)
            empty_bands = n_rt - np.unique(occupied // n_ct).size
            n_tiles = int(occupied.size) + int(empty_bands)
        else:
            n_tiles = n_rt                      # one filler slot per band
        tiled_bytes = _tiled_bytes(n_tiles, br, bc, n_rt, n_ct, rows_pad_t,
                                   cols_pad_t)
        return {
            "tiled_bytes": int(tiled_bytes),
            "n_tiles": n_tiles,
            "tile_occupancy": n_tiles / float(n_rt * n_ct),
            "tile_blocks": (br, bc),
            "tiled_rows_pad": rows_pad_t,
            "tiled_cols_pad": cols_pad_t,
        }

    # ------------------------------------------------------------------ #
    def _estimate_fd_bytes(self, g: BipartiteGraph, cfg: ReceiptConfig,
                           num_partitions: Optional[int] = None,
                           mesh=None) -> int:
        """Predicted peak of the FD phase (what the engine then keeps
        within is the plan's ``padded_bytes``): the engine's subsets as
        ``_predict_fd_subsets`` predicts them (support order, wedge-mass
        cuts, the levels the host pre-peel drains), each stacked at its
        survivors' rows and the columns its members touch (as
        ``fd.build_fd_tasks`` induces them), grouped by padded shape, in
        the engine's order.  A group drains while the next one is launched
        (the double-buffered dispatch), so the peak is the largest of a
        group's state, the next group's state and the group's update
        (``fd.fd_state_bytes``, ``fd.fd_update_bytes``).  On a ``mesh`` a
        group becomes ``mesh.size`` shards of the slots the engine's LPT
        layout gives it (``_mesh_fd_slots``: the subsets' wedge masses,
        groups in the engine's order, loads carried across groups), the
        fullest device holds the slots of its shards, and its level loops
        update one shard's slots at a time."""
        from ..core.engine.fd import _aligns, _level_pad, b2_update

        row_align, col_align, w_align = _aligns(cfg)
        p = max(num_partitions if num_partitions is not None
                else cfg.num_partitions, 1)
        subsets = _predict_fd_subsets(g, p, cfg.fd_prepeel_levels)
        if not subsets:
            return 0
        shapes: Dict[Tuple[int, int], List[float]] = {}
        for surv, cols, wsub in subsets:
            if surv == 0:
                continue                # drained by the host pre-peel
            key = (_level_pad(surv, row_align),
                   _level_pad(max(cols, 1), col_align))
            shapes.setdefault(key, []).append(wsub)
        if not shapes:
            return 0
        # the engine's group order (``pack_by_shape``: largest area first)
        keys = sorted(shapes, key=lambda k: -(k[0] * k[1]))
        if mesh is not None:
            slots = _mesh_fd_slots([shapes[k] for k in keys], mesh.size)
        states, updates = [], []
        for i, (mm, cc) in enumerate(keys):
            n_g = len(shapes[(mm, cc)])
            b2_mode = b2_update(n_g, mm, cfg)
            n_up = n_g if mesh is None else slots[i]
            n_slots = (n_g if mesh is None else
                       max(mesh.shards_per_device().values()) * slots[i])
            states.append(fd_state_bytes(n_slots, mm, cc))
            updates.append(fd_update_bytes(n_up, mm, cc, w_align, b2_mode))
        # a group drains while the next one is launched (fd_overlap)
        ahead = 1 if cfg.fd_overlap else 0
        return int(max(sum(states[i:i + 1 + ahead]) + updates[i]
                       for i in range(len(keys))))

    def _estimate_fd_groups(self, g: BipartiteGraph, cfg: ReceiptConfig,
                            num_partitions: Optional[int] = None):
        """Wedge-equipartition ESTIMATE of the FD shape groups: sorting U
        by static wedge count and cutting the cumulative mass at W/P
        boundaries predicts the subset member counts, which bucket into
        predicted stack shapes (a capacity estimate; the real groups
        depend on supports, HUC and the pre-peel)."""
        from ..core.engine.fd import _aligns, _level_pad, b2_update

        row_align, col_align, _ = _aligns(cfg)
        w = np.sort(g.wedge_counts_u().astype(np.float64))
        total = float(w.sum())
        p = max(num_partitions if num_partitions is not None
                else cfg.num_partitions, 1)
        if g.n_u == 0 or total <= 0:
            return [], 0.0
        cum = np.cumsum(w)
        cuts = np.searchsorted(cum, total / p * np.arange(1, p + 1))
        sizes = np.diff(np.concatenate([[0], np.minimum(cuts + 1, g.n_u)]))
        sizes = sizes[sizes > 0]
        cc = _level_pad(max(int((g.degrees_v() >= 2).sum()), 1), col_align)
        shapes: Dict[Tuple[int, int], int] = {}
        used = 0
        for s in sizes:
            mm = _level_pad(int(s), row_align)
            shapes[(mm, cc)] = shapes.get((mm, cc), 0) + 1
            used += int(s) * cc
        groups = [dict(rows=k[0], cols=k[1], count=v)
                  for k, v in sorted(shapes.items(), reverse=True)]
        padded = sum(g_["count"] * g_["rows"] * g_["cols"] for g_ in groups)
        waste = 1.0 - used / padded if padded else 0.0
        return groups, waste


def _freeze(v):
    """Hashable view of a config field value (for the signature); a
    torch dtype renders as its name (``"float32"``), as a jnp dtype does
    in the reference."""
    if isinstance(v, (list, tuple)):
        return tuple(v)
    if isinstance(v, torch.dtype):
        return str(v).split(".")[-1]
    if isinstance(v, type):
        return v.__name__
    return v
