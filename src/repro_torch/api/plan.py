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

from ..core.engine.peel_loop import ReceiptConfig, bucket
from ..core.graph import BipartiteGraph
from ..kernels import ops as kops
from .config import EngineConfig
from .errors import PlanInfeasibleError

__all__ = ["ExecutionPlan", "PlanMeasurements", "Planner",
           "TILED_OCCUPANCY_CROSSOVER", "TILED_MIN_DENSE_CELLS",
           "check_no_mesh"]

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


def check_no_mesh(mesh) -> None:
    """The port runs on one card: a mesh is accepted only as ``None``."""
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch runs on one device: the sharded FD path arrives "
            "with the distributed slice (ROADMAP.md, queue 1, item 6); "
            "pass mesh=None")


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
        check_no_mesh(mesh)
        if not isinstance(graph, BipartiteGraph):
            raise ValueError(
                f"Planner.plan expects a BipartiteGraph (got "
                f"{type(graph).__name__}); ingest edge lists with "
                "BipartiteGraph.from_edges or dense 0/1 matrices with "
                "BipartiteGraph.from_dense")
        graph.validate()
        cfg = self.rcfg
        backend = kops.resolve_backend(cfg.backend, self.device)
        if self.workload == "wing":
            raise PlanInfeasibleError(
                "workload='wing' (edge-axis wing decomposition) is not "
                "ported yet: it arrives with the wing slice (ROADMAP.md, "
                "queue 1, item 3); use workload='tip'",
                dispatch=cfg.cd_dispatch, backend=backend)
        g = graph.transposed() if self.side == "V" else graph
        bi, bj, bk = cfg.kernel_blocks
        mesh_shards = 0

        # --- ingestion-derived shapes (the DeviceGraph bucket math) ---- #
        dv = g.degrees_v()
        n_cols = max(int((dv >= 2).sum()), 1)   # wedge-capable V columns
        rows_pad = bucket(max(g.n_u, 1), max(bi, bj))
        cols_pad = bucket(n_cols, bk)
        if cfg.peel_width is not None:
            width0 = min(bucket(cfg.peel_width, bj), rows_pad)
        else:
            width0 = min(bucket(max(bj, rows_pad // 4), bj), rows_pad)

        # --- FD shape-group estimate (wedge-mass equipartition) -------- #
        est_groups, est_waste = self._estimate_fd_groups(g, cfg)

        # --- memory estimate ------------------------------------------- #
        itemsize = 4                                    # f32 regime
        fixed_bytes = itemsize * (
            rows_pad * cols_pad                         # CD biadjacency
            + width0 * cols_pad                         # CD peel buffer
        )
        stack_cells = sum(g_["count"] * g_["rows"] * g_["cols"]
                          for g_ in est_groups)
        padded_bytes = fixed_bytes + itemsize * stack_cells

        # --- representation routing ------------------------------------ #
        req_rep = cfg.representation
        tiled_est = self._estimate_tiled(g, cfg)
        dense_cells = rows_pad * cols_pad
        budget = self.memory_budget
        if req_rep == "tiled":
            representation = "tiled"
        elif req_rep == "auto" and (
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
                    f"the CD device matrix alone needs {fixed_bytes} "
                    f"padded bytes ({rows_pad} x {cols_pad} biadjacency + "
                    f"{width0}-row peel buffer), over the "
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
                cells = sum(g_["count"] * g_["rows"] * g_["cols"]
                            for g_ in groups_try)
                bytes_try = fixed_bytes + itemsize * cells
                if bytes_try < best[0]:
                    best = (bytes_try, p_try, groups_try, waste_try)
                if bytes_try <= budget:
                    best = (bytes_try, p_try, groups_try, waste_try)
                    found = True
                    break                           # first fit = nearest
            padded_bytes, admitted_p, est_groups, est_waste = best
            if not found and padded_bytes > budget:
                if req_rep == "auto" and tiled_est["tiled_bytes"] <= budget:
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
    def _estimate_tiled(self, g: BipartiteGraph,
                        cfg: ReceiptConfig) -> Dict[str, Any]:
        """Host-side estimate of the tiled representation's footprint,
        mirroring what ``engine.tiled.receipt_tiled`` builds: the DGM
        pre-compaction (degree-<2 V columns drop out), the degree-sort
        relabeling, then the occupied ``block_rows x block_k`` tiles.
        ``tiled_bytes`` budgets the tile payloads ~3x (the peel loop's
        regather/peel-masked copies) plus the reverse map."""
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
        tiled_bytes = 4 * (3 * n_tiles * br * bc + n_rt * n_ct
                           + 4 * rows_pad_t)
        return {
            "tiled_bytes": int(tiled_bytes),
            "n_tiles": n_tiles,
            "tile_occupancy": n_tiles / float(n_rt * n_ct),
            "tile_blocks": (br, bc),
            "tiled_rows_pad": rows_pad_t,
            "tiled_cols_pad": cols_pad_t,
        }

    # ------------------------------------------------------------------ #
    def _estimate_fd_groups(self, g: BipartiteGraph, cfg: ReceiptConfig,
                            num_partitions: Optional[int] = None):
        """Wedge-equipartition ESTIMATE of the FD shape groups: sorting U
        by static wedge count and cutting the cumulative mass at W/P
        boundaries predicts the subset member counts, which bucket into
        predicted stack shapes (a capacity estimate; the real groups
        depend on supports, HUC and the pre-peel)."""
        from ..core.engine.fd import _aligns, _level_pad

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
