"""Execution stage: ``Executor`` (plan cache + multi-graph map + the
incremental re-peel) and the ``TipDecomposition`` / ``WingDecomposition``
result objects (port of ``repro.api.executor``).

**The cache.**  The Executor keys a cache entry on
``ExecutionPlan.signature`` (bucketed matrix shape + full config) and
feeds each run the PREVIOUS same-signature runs' measurements: FD stacks
reuse their measured gather widths, and the CD width and the shape hooks'
sizes are recorded (``api/plan.py`` lists the hooks).  The reference's
cache exists to skip jit retracing; the port traces nothing, so what it
reuses is the FD widths, and ``cache_stats`` counts signature hits and
misses.

**``Executor.map``** decomposes a fleet of small graphs (cohort graphs of
one shape, as in ``examples/recsys_tip_filtering.py``): graphs are bucketed by
padded shape (``core/scheduler.pack_by_shape``), LPT-chunked under a
stack-cell budget (``core/scheduler.lpt_assign``), and each chunk is one
batched counting call (kernel 2, kernel 5 on the staircase backend, over
the whole stack with every live row carrying mass) and one
``batched_level_loop`` (kernel 2, 5 or 3 by the update mode) with
``lo = 0``: a whole-graph level peel from the initial supports is the
exact ParButterfly schedule, so results are bit-identical to per-graph
``decompose``.  The level loop reads its loop test once per sweep, so the
map report's ``host_round_trips`` counts the port's own reads.  A chunk
reuses nothing from an earlier one: the report's ``cache_hits`` /
``cache_misses`` count chunk shapes seen before, kept for parity with the
reference's report (whose hits are compiled programs).

**Failures.**  A kernel launch the card refuses, or an injected
``kernel_launch`` / ``map_chunk`` fault, raises ``KernelBackendError``.
The port's backend chain is the backend alone
(``kernels.ops.fallback_chain``): nothing reroutes to the plain versions,
so ``decompose`` raises ``KernelBackendError`` naming that one backend
(nothing is ever quarantined or rerouted: ``cache_stats``'s
``quarantined`` and ``fallback_runs`` stay 0, kept for parity), and
``map`` re-runs the members of a failed chunk one at a time on the SAME
backend, so that the error is pinned to the graph at fault.
Only ``KernelBackendError`` is treated as a kernel failure, never a bare
``RuntimeError`` (which would hide programming errors).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import tip_decompose as _engine_tip_decompose
from ..core.engine import wing_decompose_engine as _engine_wing_decompose
from ..core.engine.peel_loop import (
    ReceiptConfig,
    RunStats,
    batched_level_loop,
    bucket,
    fetch,
    resolve_device,
)
from ..core.engine.refresh import synthesize_bounds
from ..core.graph import BipartiteGraph
from ..core.scheduler import lpt_assign, pack_by_shape
from ..kernels import butterfly_sparse as ksparse
from ..kernels import ops as kops
from ..launch.mesh import check_mesh
from ..train.fault_tolerance import StragglerMonitor
from ..utils.spans import note_run
from . import faults
from .errors import (
    FleetPartialFailure,
    GraphValidationError,
    KernelBackendError,
    PlanInfeasibleError,
    ReceiptError,
    VerificationError,
)
from .plan import ExecutionPlan, Planner

__all__ = ["Executor", "Decomposition", "TipDecomposition",
           "WingDecomposition", "decompose", "verify_tip_decomposition",
           "verify_wing_decomposition"]

# the device-program failures taken for a kernel failure: the taxonomy's
# KernelBackendError (refused launches, injected faults) only
_KERNEL_FAILURES: Tuple = (KernelBackendError,)


# --------------------------------------------------------------------- #
# result objects
# --------------------------------------------------------------------- #
class Decomposition:
    """Shared protocol of decomposition results: ``numbers`` (the
    per-element level array), ``max_level()``, ``subgraph_at(k)`` and
    ``to_dict()``.  Subclasses set ``workload`` and ``axis``."""

    workload: str = ""
    axis: str = ""                   # "vertex" | "edge"

    @property
    def numbers(self) -> np.ndarray:
        """Per-element decomposition levels (int64, canonical order)."""
        raise NotImplementedError

    def max_level(self) -> int:
        """The densest level present (0 for an empty peel axis)."""
        nums = self.numbers
        return int(nums.max()) if nums.size else 0

    def subgraph_at(self, k: float):
        raise NotImplementedError

    def to_dict(self) -> Dict:
        """JSON-able summary: workload, sizes, levels."""
        g = self.graph                               # type: ignore[attr-defined]
        return {
            "workload": self.workload,
            "axis": self.axis,
            "side": self.side,                       # type: ignore[attr-defined]
            "n_u": int(g.n_u),
            "n_v": int(g.n_v),
            "m": int(g.m),
            "numbers": [int(x) for x in np.asarray(self.numbers)],
            "max_level": self.max_level(),
        }


@dataclasses.dataclass
class TipDecomposition(Decomposition):
    """Result of one tip decomposition: tip numbers + run evidence +
    hierarchy queries.

    ``theta[i]`` is the tip number of vertex ``i`` of the PEELED side
    (``side``); ``subgraph_at(k)`` induces the k-tip (paper §2).
    """

    graph: BipartiteGraph            # the ingested (un-transposed) graph
    side: str
    theta: np.ndarray                # int64[n_side]
    stats: RunStats
    plan: Optional[ExecutionPlan] = None

    workload = "tip"
    axis = "vertex"

    @property
    def numbers(self) -> np.ndarray:
        return self.theta

    @property
    def n(self) -> int:
        return int(self.theta.size)

    def vertex_tip(self, v: int) -> int:
        """Tip number of one peeled-side vertex (alias of
        ``numbers[v]``)."""
        if not 0 <= v < self.theta.size:
            raise IndexError(
                f"vertex {v} out of range for side {self.side!r} "
                f"(n={self.theta.size})")
        return int(self.theta[v])

    def max_theta(self) -> int:
        """Alias of ``max_level()``."""
        return self.max_level()

    def subgraph_at(self, theta_min: float):
        """The theta_min-tip: the subgraph induced on peeled-side
        vertices with tip number >= ``theta_min`` (plus every V column
        they still touch).  Returns ``(subgraph, members, v_ids)``."""
        g = self.graph.transposed() if self.side == "V" else self.graph
        members = np.where(self.theta >= theta_min)[0]
        sub, v_ids = g.induced_on_u(members)
        return sub, members, v_ids


@dataclasses.dataclass
class WingDecomposition(Decomposition):
    """Result of one wing (bitruss) decomposition: per-EDGE wing numbers
    + run evidence + hierarchy queries.

    ``edge_wing[e]`` is the wing number psi of edge ``e`` in the graph's
    canonical edge order (``graph.edges_u[e], graph.edges_v[e]``),
    whatever ``side`` (wing numbers are side-symmetric).
    ``subgraph_at(k)`` keeps the edges with psi >= k (the k-wing).
    """

    graph: BipartiteGraph            # the ingested (un-transposed) graph
    side: str
    edge_wing: np.ndarray            # int64[m], canonical edge order
    stats: RunStats
    plan: Optional[ExecutionPlan] = None

    workload = "wing"
    axis = "edge"

    @property
    def numbers(self) -> np.ndarray:
        return self.edge_wing

    @property
    def m(self) -> int:
        return int(self.edge_wing.size)

    def edge_psi(self, e: int) -> int:
        """Wing number of one edge (alias of ``numbers[e]``)."""
        if not 0 <= e < self.edge_wing.size:
            raise IndexError(
                f"edge {e} out of range (m={self.edge_wing.size})")
        return int(self.edge_wing[e])

    def max_psi(self) -> int:
        """Alias of ``max_level()``."""
        return self.max_level()

    def subgraph_at(self, psi_min: float):
        """The psi_min-wing: the edges with wing number >= ``psi_min``,
        vertex sets kept at original ids.  Returns ``(subgraph,
        edge_ids)``, the ids indexing ``graph.edges_u``/``edges_v``."""
        keep = np.where(self.edge_wing >= psi_min)[0]
        sub = BipartiteGraph.from_edges(
            self.graph.n_u, self.graph.n_v,
            self.graph.edges_u[keep], self.graph.edges_v[keep])
        return sub, keep


# --------------------------------------------------------------------- #
# cache
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class _CacheEntry:
    runs: int = 0
    cd_peel_width: Optional[int] = None
    fd_level_widths: Dict[Tuple[int, int], int] = dataclasses.field(
        default_factory=dict)


class Executor:
    """Holds the reuse state for one configuration on one device.

    ``decompose(graph)`` plans (or takes a plan), seeds it from the cache
    entry of its signature, runs the engine, and folds the run's
    measurements back.  ``map(graphs)`` batches a fleet of small graphs
    (module docstring).  ``device=None`` runs on the card and raises when
    there is none; pass ``device="cpu"`` for the plain versions.
    ``mesh`` (a ``repro_torch.launch.mesh.DeviceMesh``): ``decompose``
    runs the FD phase sharded over it (CD stays on ``device``); ``map``
    and the wing workload refuse it, as the reference's do.
    """

    def __init__(self, config=None, *, side: Optional[str] = None,
                 device=None, mesh=None, map_stack_cells: int = 1 << 26,
                 guardrails: bool = True):
        if mesh is not None:
            check_mesh(mesh)
        self.device = resolve_device(device)
        self.mesh = mesh
        self._planner = Planner(config, side=side, device=self.device)
        self.map_stack_cells = int(map_stack_cells)
        self._entries: Dict[Tuple, _CacheEntry] = {}
        self._map_sigs: set = set()      # chunk shapes map has run
        self._hits = 0
        self._misses = 0
        self.last_map_report: Optional[Dict] = None
        # guardrails=False strips the degradation machinery from the hot
        # path (no input validation in map, no fault-point consults, no
        # chunk isolation, no straggler timing)
        self.guardrails = bool(guardrails)
        api_cfg = self._planner.config
        spec = api_cfg.fault_spec if api_cfg is not None else None
        self._injector = faults.FaultInjector(spec) if spec else None
        self._stragglers = StragglerMonitor()

    # ------------------------------------------------------------------ #
    @property
    def config(self) -> ReceiptConfig:
        """The engine-layer config this executor runs."""
        return self._planner.rcfg

    @property
    def side(self) -> str:
        return self._planner.side

    @property
    def workload(self) -> str:
        return self._planner.workload

    @property
    def cache_stats(self) -> Dict[str, int]:
        # nothing is quarantined or rerouted (one-backend chain): the two
        # last fields stay 0, kept for parity with the reference
        return dict(entries=len(self._entries), hits=self._hits,
                    misses=self._misses, quarantined=0, fallback_runs=0)

    @property
    def fault_report(self) -> List[Dict]:
        """Per-rule hit/fire accounting of this executor's injector
        (empty when ``EngineConfig.fault_spec`` is unset)."""
        return self._injector.report() if self._injector else []

    def plan(self, graph: BipartiteGraph) -> ExecutionPlan:
        return self._planner.plan(graph, mesh=self.mesh)

    def _fault_scope(self):
        """Activate this executor's injector (env-armed faults apply
        regardless through ``faults.active_injector``)."""
        if self.guardrails and self._injector is not None:
            return faults.inject(self._injector)
        if not self.guardrails:
            return faults.suppressed()
        return contextlib.nullcontext()

    # ------------------------------------------------------------------ #
    # single-graph plan/execute
    # ------------------------------------------------------------------ #
    def decompose(self, graph: BipartiteGraph,
                  plan: Optional[ExecutionPlan] = None, *,
                  verify: bool = False) -> Decomposition:
        """Full RECEIPT decomposition of one graph through the cache:
        ``workload="tip"`` returns a ``TipDecomposition`` (theta per
        peeled-side vertex), ``workload="wing"`` a ``WingDecomposition``
        (psi per edge).

        ``verify=True`` re-derives the paper's invariants from the result
        (``verify_tip_decomposition`` / ``verify_wing_decomposition``, on
        the host in float64) and records the check count in ``RunStats``;
        a violation raises ``VerificationError``.

        Tip numbers are exact below the route's limit
        (``core.engine.peel_loop.exact_limit``: 2^53, or 2^24 on the tiled
        representation and with a mesh); a counted support at or past it
        raises ``PlanInfeasibleError`` and returns no numbers.
        """
        if self.workload == "wing" and self.mesh is not None:
            raise ValueError(
                "workload='wing' runs single-device; the sharded FD "
                "is a vertex-axis path.  Build the executor without a "
                "mesh.")
        if plan is None:
            plan = self.plan(graph)
        entry = self._seed(plan)
        numbers, stats = self._execute(graph, plan)
        self._absorb(plan, entry)
        if self.workload == "wing":
            if verify:
                stats.verify_checks = verify_wing_decomposition(
                    graph, numbers, bounds=stats.bounds,
                    plan_signature=plan.signature)
                stats.verified = True
            return WingDecomposition(graph=graph, side=self.side,
                                     edge_wing=numbers, stats=stats,
                                     plan=plan)
        if verify:
            stats.verify_checks = verify_tip_decomposition(
                graph, self.side, numbers, bounds=stats.bounds,
                plan_signature=plan.signature)
            stats.verified = True
        return TipDecomposition(graph=graph, side=self.side, theta=numbers,
                                stats=stats, plan=plan)

    # ------------------------------------------------------------------ #
    # incremental re-peel (the serving layer's refresh)
    # ------------------------------------------------------------------ #
    def repeel(self, graph: BipartiteGraph, *, sup0: np.ndarray,
               numbers_old: np.ndarray, stops: Sequence[float],
               watch: np.ndarray,
               plan: Optional[ExecutionPlan] = None,
               stats: Optional[RunStats] = None
               ) -> Tuple[np.ndarray, RunStats]:
        """Exact incremental refresh: prefix re-peel of the POST-mutation
        ``graph`` from delta-maintained supports, stopping at the first
        rung of ``stops`` that clears the mutation ceiling
        (``core.engine.refresh``).

        ``sup0``/``numbers_old`` are the maintained whole-graph supports
        and the pre-mutation levels on the peeled axis in canonical order
        (per vertex for tip — ``side="V"`` transposes, as ``decompose``
        does — per edge for wing); ``stops`` the ascending ladder (first
        rung above the deletion ceiling); ``watch`` the inserted elements.

        Runs on the plan's one backend; plans routed to the tiled
        representation are rejected (the refresh loops are dense).
        Returns ``(numbers_new int64, stats)`` with ``refresh_mode`` and
        ``refresh_stop`` set — bit-identical to
        ``decompose(graph).numbers``.  ``stats``: the ``RunStats`` to
        fill (a fresh one by default), so that a caller's own spans and
        reads of the refresh land on the same run.
        """
        from ..core.engine.refresh import (repeel_tip_prefix,
                                           repeel_wing_prefix)

        if plan is None:
            plan = self.plan(graph)
        if plan.representation == "tiled":
            raise PlanInfeasibleError(
                "incremental re-peel runs on the dense geometry; this "
                "plan routed to the tiled representation — refresh by "
                "full recompute instead", plan_signature=plan.signature,
                dispatch="repeel")
        entry = self._seed(plan)
        rcfg = self._run_cfg(plan.backend, plan)
        if self.workload == "tip" and self.side == "V":
            graph = graph.transposed()
        stats = RunStats() if stats is None else stats
        stats.refresh_mode = "delta"
        repeel = (repeel_wing_prefix if self.workload == "wing"
                  else repeel_tip_prefix)
        with self._fault_scope():
            numbers, _stop = repeel(graph, sup0, numbers_old, stops, watch,
                                    rcfg, stats, device=self.device,
                                    plan=plan)
        stats.backend_used = plan.backend
        self._absorb(plan, entry)
        note_run(stats)
        return numbers, stats

    def _run_cfg(self, backend: str, plan: ExecutionPlan) -> ReceiptConfig:
        """Engine config of one execution attempt: the plan's backend,
        admitted partition count and resolved representation are
        authoritative."""
        rcfg = self.config
        kw = {}
        if kops.resolve_backend(rcfg.backend, self.device) != backend:
            kw["backend"] = backend
        if self._planner.memory_budget is not None:
            kw["num_partitions"] = plan.num_partitions
        if rcfg.representation != plan.representation:
            kw["representation"] = plan.representation
        return dataclasses.replace(rcfg, **kw) if kw else rcfg

    def _execute(self, graph: BipartiteGraph, plan: ExecutionPlan):
        """Run the engine on the plan's backend; the port's chain is that
        backend alone (module docstring), so a kernel failure raises
        ``KernelBackendError`` naming it."""
        backend = plan.backend
        with self._fault_scope():
            try:
                theta, stats = self._engine_run(
                    graph, self._run_cfg(backend, plan), plan)
            except _KERNEL_FAILURES as e:
                if not self.guardrails:
                    raise
                raise KernelBackendError(
                    f"every backend in the fallback chain failed: "
                    f"{' -> '.join(kops.fallback_chain(backend))} "
                    f"(last: {type(e).__name__}: {e})",
                    plan_signature=plan.signature, dispatch=plan.cd_dispatch,
                    backend=backend) from e
        stats.backend_used = backend
        note_run(stats)
        return theta, stats

    def _engine_run(self, graph: BipartiteGraph, cfg: ReceiptConfig,
                    plan: ExecutionPlan):
        """One engine invocation of the plan's workload."""
        if self.workload == "wing":
            return _engine_wing_decompose(graph, cfg, side=self.side,
                                          device=self.device, plan=plan)
        return _engine_tip_decompose(graph, cfg, side=self.side,
                                     device=self.device, mesh=self.mesh,
                                     plan=plan)

    def _seed(self, plan: ExecutionPlan) -> _CacheEntry:
        entry = self._entries.get(plan.signature)
        if entry is None:
            self._misses += 1
            entry = _CacheEntry()
            self._entries[plan.signature] = entry
        else:
            self._hits += 1
            plan.measured.cd_peel_width = entry.cd_peel_width
            plan.measured.fd_level_widths = dict(entry.fd_level_widths)
        plan.measured.runs = entry.runs
        return entry

    def _absorb(self, plan: ExecutionPlan, entry: _CacheEntry) -> None:
        m = plan.measured
        if m.cd_peel_width is not None:
            entry.cd_peel_width = max(entry.cd_peel_width or 0,
                                      m.cd_peel_width)
        for shape, width in m.fd_level_widths.items():
            entry.fd_level_widths[shape] = max(
                entry.fd_level_widths.get(shape, 1), width)
        entry.runs += 1
        m.runs = entry.runs

    # ------------------------------------------------------------------ #
    # multi-graph batched decomposition
    # ------------------------------------------------------------------ #
    def map(self, graphs: Sequence[BipartiteGraph], *,
            strict: bool = False) -> List:
        """Decompose a fleet of small graphs in a handful of batched calls
        (module docstring); bit-identical tip numbers to per-graph
        ``decompose``.

        Per shape bucket (rows x wedge-capable cols), graphs are
        LPT-chunked under ``map_stack_cells``; each chunk costs one
        batched counting call and one batched level loop (re-entered only
        on a ``max_sweeps`` cap-exit).  ``last_map_report`` records the
        dispatch accounting.

        **Fleet isolation**: the returned list has one slot PER INPUT
        GRAPH — a ``TipDecomposition`` for every healthy member, the
        member's own ``ReceiptError`` for every failed one.  A chunk
        whose batched call fails is re-run one member at a time on the
        same backend, so only the bad graph carries an error (a
        single-member chunk takes its error slot directly).
        ``strict=True`` raises ``FleetPartialFailure`` aggregating the
        per-graph errors instead.
        """
        cfg = self.config
        if self.workload != "tip":
            raise PlanInfeasibleError(
                "Executor.map batches VERTEX-axis (tip) decompositions; "
                f"workload={self.workload!r} is not mappable — use "
                "Executor.decompose per graph (the wing FD stack already "
                "batches its subsets)", dispatch="map")
        if cfg.fd_mode != "level":
            raise ValueError(
                "Executor.map batches graphs through the level-peel "
                f"loop; set fd_mode='level' (got {cfg.fd_mode!r})")
        if self.mesh is not None:
            raise ValueError(
                "Executor.map runs single-device; sharding map chunks "
                "over a mesh is not implemented.  Use "
                "Executor.decompose(graph) for mesh execution, or build "
                "the executor without a mesh.")
        t0 = time.perf_counter()
        backend = kops.resolve_backend(cfg.backend, self.device)
        blocks = cfg.kernel_blocks
        results: List[Optional[TipDecomposition]] = [None] * len(graphs)
        errors: Dict[int, ReceiptError] = {}
        report = dict(n_graphs=len(graphs), groups=0, chunks=0,
                      counting_dispatches=0, device_loop_calls=0,
                      host_round_trips=0, cache_hits=0, cache_misses=0,
                      backend=backend, wall_s=0.0,
                      chunk_failures=0, chunk_retries=0, isolated_graphs=0,
                      errors={}, stragglers=[])
        with self._fault_scope():
            tasks = []
            for i, g in enumerate(graphs):
                try:
                    tasks.append(self._map_task(i, g, backend))
                except ReceiptError as e:
                    errors[i] = e

            groups = pack_by_shape(
                tasks,
                size_of=lambda t: (t["rows_pad"], t["cols_pad"]),
                weight_of=lambda t: t["wedges"],
                bucket=lambda n: n,    # tasks carry pre-bucketed shapes
            )
            report["groups"] = len(groups)
            for group in groups:
                mm, cc = group[0]["rows_pad"], group[0]["cols_pad"]
                # LPT-chunk the group under the stack-cell budget; the fit
                # count rounds DOWN to a power of two so the padded group
                # dim (bucket(g, 1) in _map_chunk) stays inside the budget
                per_graph = mm * cc
                n_fit = max(int(self.map_stack_cells // max(per_graph, 1)),
                            1)
                n_fit = 1 << (n_fit.bit_length() - 1)
                n_chunks = max(-(-len(group) // n_fit), 1)
                chunks = lpt_assign([t["wedges"] for t in group], n_chunks)
                for chunk_idx in chunks:
                    # LPT balances wedge mass, not counts: slice any chunk
                    # that still exceeds the fit count
                    for lo_i in range(0, len(chunk_idx), n_fit):
                        part = chunk_idx[lo_i:lo_i + n_fit]
                        self._map_chunk_guarded(
                            [group[i] for i in part], mm, cc, backend,
                            blocks, results, report, errors)
        # straggler flagging: per-chunk wall clocks EWMA'd in the shared
        # StragglerMonitor; members of flagged chunks carry the mark
        strag = set(self._stragglers.stragglers())
        if strag:
            report["stragglers"] = sorted(
                s for s in strag if isinstance(s, tuple) and s[0] == "map")
            for r in results:
                if (r is not None
                        and getattr(r.stats, "chunk_sig", None) in strag):
                    r.stats.straggler = True
        report["errors"] = {
            i: f"{type(e).__name__}: {e}" for i, e in sorted(errors.items())}
        report["wall_s"] = time.perf_counter() - t0
        self.last_map_report = report
        if errors and strict:
            raise FleetPartialFailure(
                "Executor.map(strict=True)", errors=errors,
                n_ok=sum(1 for r in results if r is not None),
                backend=backend)
        out: List = list(results)
        for i, e in errors.items():
            out[i] = e
        return out

    # ------------------------------------------------------------------ #
    def _map_task(self, idx: int, graph: BipartiteGraph,
                  backend: str) -> Dict:
        """Ingest one graph of the fleet: side selection, degree-sort
        relabeling (as ``engine.tip_decompose``), wedge-capable column
        compaction, bucketed shape (the kernel blocks on every backend)."""
        cfg = self.config
        if not isinstance(graph, BipartiteGraph):
            raise GraphValidationError(
                f"Executor.map expects BipartiteGraphs, got "
                f"{type(graph).__name__}", graph_index=idx)
        if self.guardrails:
            try:
                graph.validate()
            except GraphValidationError as e:
                raise GraphValidationError(
                    e.message, graph_index=idx, **e.context) from None
        g = graph.transposed() if self.side == "V" else graph
        if cfg.degree_sort:
            perm_u = np.argsort(-g.degrees_u(), kind="stable")
            perm_v = np.argsort(-g.degrees_v(), kind="stable")
            inv_u = np.empty_like(perm_u)
            inv_u[perm_u] = np.arange(g.n_u)
            inv_v = np.empty_like(perm_v)
            inv_v[perm_v] = np.arange(g.n_v)
            g_work = BipartiteGraph.from_edges(
                g.n_u, g.n_v, inv_u[g.edges_u], inv_v[g.edges_v])
        else:
            perm_u = np.arange(g.n_u)
            g_work = g
        # drop V columns that cannot center a wedge (the DGM compaction)
        sub, _ = g_work.induced_on_u(np.arange(g_work.n_u), min_degree_v=2)
        bi, bj, bk = cfg.kernel_blocks
        return dict(
            idx=idx, graph=graph, n_u=g.n_u, perm_u=perm_u, sub=sub,
            rows_pad=bucket(max(g.n_u, 1), max(bi, bj)),
            cols_pad=bucket(max(sub.n_v, 1), bk),
            wedges=float(sub.wedge_counts_u().sum()),
        )

    def _map_chunk_guarded(self, chunk: List[Dict], mm: int, cc: int,
                           backend: str, blocks, results: List,
                           report: Dict, errors: Dict[int, ReceiptError]
                           ) -> None:
        """Fleet isolation around one chunk (module docstring): on a
        failure of the batched call, each member is re-run alone on the
        same backend, so that only the graph at fault carries an error;
        healthy members of a failing chunk keep their (bit-identical)
        results."""
        if not self.guardrails:
            self._map_chunk(chunk, mm, cc, backend, blocks, results, report)
            return
        try:
            self._map_chunk(chunk, mm, cc, backend, blocks, results, report)
            return
        except ReceiptError as e:
            report["chunk_failures"] += 1
            if len(chunk) == 1:
                errors[chunk[0]["idx"]] = e
                return
        for t in chunk:
            try:
                self._map_chunk([t], mm, cc, backend, blocks, results,
                                report)
                report["isolated_graphs"] += 1
            except ReceiptError as e:
                errors[t["idx"]] = e

    def _map_chunk(self, chunk: List[Dict], mm: int, cc: int, backend: str,
                   blocks, results: List, report: Dict) -> None:
        """Decompose one stacked chunk: batched counting, batched level
        peel, one fetch per level-loop invocation."""
        t_chunk = time.perf_counter()
        faults.fault_point(
            "map_chunk", KernelBackendError, chunk=report["chunks"],
            backend=backend, n_graphs=len(chunk))
        cfg = self.config
        dev = self.device
        sparse = backend in kops.SPARSE_BACKENDS
        g_real = len(chunk)
        g_pad = bucket(g_real, 1)               # pow2 group dim
        sig = ("map", g_pad, mm, cc, backend, tuple(blocks),
               cfg.fd_update_mode, cfg.max_sweeps)
        # parity only: a chunk reuses nothing (module docstring)
        report["cache_hits" if sig in self._map_sigs else "cache_misses"] += 1
        self._map_sigs.add(sig)

        a = np.zeros((g_pad, mm, cc), np.float32)
        nmem = np.zeros(g_pad, np.int32)
        for k, t in enumerate(chunk):
            s = t["sub"]
            a[k, s.edges_u, s.edges_v] = 1.0
            nmem[k] = t["n_u"]
        alive0 = np.arange(mm)[None, :] < nmem[:, None]

        a_dev = torch.from_numpy(a).to(device=dev, dtype=cfg.dtype)
        alive_dev = torch.from_numpy(alive0).to(dev)
        dv0 = a_dev.sum(dim=1)
        ids = torch.arange(mm, dtype=torch.int32, device=dev).expand(
            g_pad, mm).contiguous()
        if sparse:
            row_ext = ksparse.row_extents_device(a_dev, blocks[2])
            kma = ksparse.tile_extents(row_ext, blocks[0])
        else:
            row_ext = kma = None
        syncs = RunStats()                      # the port's reads, counted
        faults.fault_point("kernel_launch", KernelBackendError,
                           dispatch="map", backend=backend, phase="count")
        # batched per-vertex counting: one kernel call for the chunk,
        # A = B and every live row carrying mass
        sup0 = kops.butterfly_update_batched(
            a_dev, a_dev, alive_dev.to(a_dev.dtype), ids, ids,
            backend=backend, blocks=blocks, kmax_a=kma, kmax_b=kma)
        report["counting_dispatches"] += 1
        sup0 = torch.where(alive_dev, sup0, float("inf"))
        if cfg.fd_update_mode == "auto":
            update_mode = ("b2" if g_pad * mm * mm <= cfg.fd_b2_cells
                           else "kernel")
        else:
            update_mode = cfg.fd_update_mode
        lo = torch.zeros(g_pad, dtype=torch.float32, device=dev)

        # whole-graph level peel (lo = 0: the exact ParB schedule);
        # peel_width = mm selects the mask form, no gather
        def level_loop(sup, alive, dv):
            report["device_loop_calls"] += 1
            return batched_level_loop(
                a_dev, sup, alive, dv, lo, backend=backend, blocks=blocks,
                peel_width=mm, max_sweeps=cfg.max_sweeps,
                update_mode=update_mode, row_ext=row_ext, stats=syncs)

        out = level_loop(sup0, alive_dev, dv0)
        # drain with cap-exit re-entry (theta/rho/wedges accumulate per
        # invocation, as the FD group drain)
        th_acc = np.zeros((g_pad, mm), np.float64)
        rho_acc = np.zeros(g_pad, np.int64)
        wedges_acc = np.zeros(g_pad, np.float64)
        prev_alive = alive0
        while True:
            sup, alive, dv, th, rho, wedges, _maxlev, _sweeps = out
            th_h, alive_h, rho_h, wedges_h = fetch(syncs, th, alive, rho,
                                                   wedges)
            alive_h = alive_h.astype(bool)
            newly_dead = prev_alive & ~alive_h
            th_acc = np.where(newly_dead, th_h, th_acc)
            rho_acc += rho_h.astype(np.int64)
            wedges_acc += wedges_h
            if not alive_h.any() or int(rho_h.sum()) == 0:
                break
            prev_alive = alive_h
            out = level_loop(sup, alive, dv)     # cap-exit re-entry
        report["host_round_trips"] += syncs.host_round_trips
        report["chunks"] += 1
        chunk_id = ("map", mm, cc, report["chunks"])
        if self.guardrails:
            self._stragglers.record(chunk_id,
                                    time.perf_counter() - t_chunk)

        for k, t in enumerate(chunk):
            theta = np.zeros(t["n_u"], np.int64)
            theta[t["perm_u"]] = np.round(th_acc[k, : t["n_u"]]).astype(
                np.int64)
            stats = RunStats()
            stats.rho_fd = int(rho_acc[k])
            stats.wedges_fd = int(wedges_acc[k])
            stats.wedges_pvbcnt = t["graph"].counting_wedge_bound()
            stats.backend_used = backend
            stats.chunk_sig = chunk_id     # straggler flagging key (map)
            # an equi-mass stop ladder from the exact theta in hand (the
            # whole-graph level schedule builds no CD bounds)
            stats.bounds = synthesize_bounds(theta, cfg.num_partitions)
            results[t["idx"]] = TipDecomposition(
                graph=t["graph"], side=self.side, theta=theta, stats=stats)


# --------------------------------------------------------------------- #
# verify mode: recompute the paper's invariants from the result
# --------------------------------------------------------------------- #
def _butterfly_supports_host(g: BipartiteGraph,
                             members: np.ndarray) -> np.ndarray:
    """Butterfly supports of ``members`` in their induced subgraph,
    recomputed on the host with an independent formulation (float64 dense
    wedge matrix ``W = A @ A.T``, ``B[u] = sum_{u' != u} C(W[u, u'], 2)``),
    so verify mode shares no code with the kernels it checks."""
    pos = np.full(g.n_u, -1, np.int64)
    pos[members] = np.arange(members.size)
    keep = pos[g.edges_u] >= 0
    a = np.zeros((members.size, g.n_v), np.float64)
    a[pos[g.edges_u[keep]], g.edges_v[keep]] = 1.0
    w = a @ a.T
    cw = w * (w - 1.0) / 2.0
    np.fill_diagonal(cw, 0.0)
    return cw.sum(axis=1)


def verify_tip_decomposition(graph: BipartiteGraph, side: str,
                             theta: np.ndarray, *,
                             bounds: Optional[Sequence[float]] = None,
                             max_boundaries: int = 8,
                             plan_signature=None) -> int:
    """Check a claimed tip decomposition against RECEIPT's invariants;
    returns the number of checks performed, raises ``VerificationError``
    on the first violation.

    1. shape/domain: ``theta`` covers the peeled side, no negatives;
    2. support bound: ``theta[u] <= B0[u]``;
    3. bound monotonicity: the CD subset bounds are non-decreasing and
       ``theta.max() < bounds[-1]``;
    4. theta containment at each boundary ``b``: every member of
       ``{u : theta[u] >= b}`` has support >= b INDUCED ON THE SET (by
       maximality of the b-tip this catches any upward-corrupted theta).

    Supports are recomputed on the host by ``_butterfly_supports_host``
    (a dense float64 ``A A^T``: meant for graphs of a few thousand
    vertices, not the full-size ones).
    """
    g = graph.transposed() if side == "V" else graph
    th = np.asarray(theta)
    checks = 0

    def _fail(msg, **ctx):
        raise VerificationError(msg, plan_signature=plan_signature, **ctx)

    if th.shape != (g.n_u,):
        _fail(f"theta shape {th.shape} != peeled side ({g.n_u},)")
    checks += 1
    if th.size == 0:
        return checks
    if np.any(th < 0):
        _fail(f"negative tip numbers at "
              f"{np.where(th < 0)[0][:4].tolist()}")
    checks += 1

    sup0 = _butterfly_supports_host(g, np.arange(g.n_u))
    bad = np.where(th > sup0 + 0.5)[0]
    if bad.size:
        u = int(bad[0])
        _fail(f"theta exceeds initial butterfly support: theta[{u}]="
              f"{int(th[u])} > B0[{u}]={sup0[u]:.0f} "
              f"({bad.size} violation(s))")
    checks += 1

    if bounds:
        bs = [float(b) for b in bounds]
        if any(b2 < b1 for b1, b2 in zip(bs, bs[1:])):
            _fail(f"CD subset bounds not monotone: {bs}")
        checks += 1
        if float(th.max()) >= bs[-1]:
            _fail(f"theta.max()={int(th.max())} >= terminal bound "
                  f"{bs[-1]} (bounds[-1] must exceed theta_max)")
        checks += 1
        levels = sorted({b for b in bs if 0.0 < b < np.inf})
    else:
        # no bounds recorded: probe up to max_boundaries distinct
        # positive theta levels instead
        uniq = np.unique(th[th > 0]).astype(np.float64)
        if uniq.size > max_boundaries:
            pick = np.linspace(0, uniq.size - 1, max_boundaries)
            uniq = uniq[np.round(pick).astype(int)]
        levels = [float(b) for b in uniq]

    for b in levels:
        members = np.where(th >= b)[0]
        if members.size == 0:
            continue
        sup = _butterfly_supports_host(g, members)
        low = np.where(sup < b - 0.5)[0]
        if low.size:
            u = int(members[low[0]])
            _fail(f"theta containment violated at boundary {b:.0f}: "
                  f"vertex {u} (theta={int(th[u])}) has induced support "
                  f"{sup[low[0]]:.0f} < {b:.0f}", boundary=b)
        checks += 1
    return checks


def _edge_supports_host(g: BipartiteGraph, keep: np.ndarray) -> np.ndarray:
    """Butterfly supports of the ``keep`` edges in the subgraph they
    induce, recomputed on the host with an independent route (float64
    wedge matrix ``W = A @ A.T``; the support of edge (u, v) is
    ``(W @ A)[u, v] - du[u] - dv[v] + 1``) — no code shared with the
    kernels it checks."""
    eu, ev = g.edges_u[keep], g.edges_v[keep]
    a = np.zeros((g.n_u, g.n_v), np.float64)
    a[eu, ev] = 1.0
    s = (a @ a.T) @ a
    du = a.sum(axis=1)
    dvv = a.sum(axis=0)
    return s[eu, ev] - du[eu] - dvv[ev] + 1.0


def verify_wing_decomposition(graph: BipartiteGraph, psi: np.ndarray, *,
                              bounds: Optional[Sequence[float]] = None,
                              max_boundaries: int = 8,
                              plan_signature=None) -> int:
    """Check a claimed wing decomposition against RECEIPT's invariants
    (the edge-axis ``verify_tip_decomposition``); returns the number of
    checks performed, raises ``VerificationError`` on the first
    violation.

    1. shape/domain: ``psi`` covers the canonical edge list, no
       negatives;
    2. support bound: ``psi[e] <= B0[e]``;
    3. bound monotonicity: CD subset bounds non-decreasing and
       ``psi.max() < bounds[-1]``;
    4. psi containment at each boundary ``b``: every edge of
       ``{e : psi[e] >= b}`` has support >= b INDUCED ON THE SET.

    ``psi`` is side-agnostic, so supports are recomputed on the graph's
    canonical edge order (``_edge_supports_host``, dense float64: meant
    for graphs of a few thousand vertices).
    """
    g = graph
    ps = np.asarray(psi)
    checks = 0

    def _fail(msg, **ctx):
        raise VerificationError(msg, plan_signature=plan_signature, **ctx)

    if ps.shape != (g.m,):
        _fail(f"psi shape {ps.shape} != canonical edge list ({g.m},)")
    checks += 1
    if ps.size == 0:
        return checks
    if np.any(ps < 0):
        _fail(f"negative wing numbers at "
              f"{np.where(ps < 0)[0][:4].tolist()}")
    checks += 1

    sup0 = _edge_supports_host(g, np.arange(g.m))
    bad = np.where(ps > sup0 + 0.5)[0]
    if bad.size:
        e = int(bad[0])
        _fail(f"psi exceeds initial butterfly support: psi[{e}]="
              f"{int(ps[e])} > B0[{e}]={sup0[e]:.0f} "
              f"({bad.size} violation(s))")
    checks += 1

    if bounds:
        bs = [float(b) for b in bounds]
        if any(b2 < b1 for b1, b2 in zip(bs, bs[1:])):
            _fail(f"CD subset bounds not monotone: {bs}")
        checks += 1
        if float(ps.max()) >= bs[-1]:
            _fail(f"psi.max()={int(ps.max())} >= terminal bound "
                  f"{bs[-1]} (bounds[-1] must exceed psi_max)")
        checks += 1
        levels = sorted({b for b in bs if 0.0 < b < np.inf})
    else:
        uniq = np.unique(ps[ps > 0]).astype(np.float64)
        if uniq.size > max_boundaries:
            pick = np.linspace(0, uniq.size - 1, max_boundaries)
            uniq = uniq[np.round(pick).astype(int)]
        levels = [float(b) for b in uniq]

    for b in levels:
        keep = np.where(ps >= b)[0]
        if keep.size == 0:
            continue
        sup = _edge_supports_host(g, keep)
        low = np.where(sup < b - 0.5)[0]
        if low.size:
            e = int(keep[low[0]])
            _fail(f"psi containment violated at boundary {b:.0f}: edge "
                  f"{e} ({int(g.edges_u[e])},{int(g.edges_v[e])}) "
                  f"(psi={int(ps[e])}) has induced support "
                  f"{sup[low[0]]:.0f} < {b:.0f}", boundary=b)
        checks += 1
    return checks


# --------------------------------------------------------------------- #
# one-shot convenience (the facade's entry point)
# --------------------------------------------------------------------- #
def decompose(graph: BipartiteGraph, config=None, *,
              side: Optional[str] = None, device=None, mesh=None,
              plan: Optional[ExecutionPlan] = None,
              verify: bool = False) -> Decomposition:
    """Plan + execute one decomposition on a fresh Executor.

    ``config`` may be an ``EngineConfig``, a legacy ``ReceiptConfig`` or
    None.  A fresh Executor means no cross-call reuse — exactly the
    engine's own sizing; hold an ``Executor`` to reuse measurements.
    ``EngineConfig(workload="wing")`` returns a ``WingDecomposition``.
    ``device=None`` runs on the card.
    """
    return Executor(config, side=side, device=device, mesh=mesh).decompose(
        graph, plan=plan, verify=verify)
