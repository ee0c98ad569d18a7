"""The peel core (port of ``repro.core.engine.peel_loop``).

One sweep engine drives the peel schedules:

* **CD range-peel** (Alg. 3): peel everything with support < ``hi`` until
  the range drains; support updates cap at ``lo`` = theta(i).
  ``device_peel_loop(minmode=False)`` — one invocation per subset, used by
  the subset dispatch of `engine/cd.py`.
* **whole-graph CD** (DESIGN.md section 2.3): ``device_cd_graph_loop`` runs
  every subset of the CD phase over state that stays on the device; at
  each subset boundary it compacts the residual graph on the card
  (on-device DGM), re-tightens the staircase extents, re-estimates the HUC
  bound and picks the next range with ``kernels.ops.find_hi_device`` —
  used by the graph dispatch of `engine/cd.py`.
* **min-peel** (ParB schedule): each sweep peels the current
  minimum-support set.  ``device_peel_loop(minmode=True)``.
* **FD level-peel** (Alg. 4): peel the entire current-minimum support
  level per sweep, batched over a stack of independent induced subgraphs.
  ``batched_level_loop`` — used by `engine/fd.py`.

The reference runs these loops as ``lax.while_loop``s with ``lax.cond``
branches; here they are Python loops over device tensors.  Each sweep
reads its peel-set and alive sizes on the host in one transfer (the loop
test, the elision test and, in the graph loop, the "range drained?" test
at once), and the HUC peel-vs-recount choice (decided on the device, as
the reference's f32 comparison) in one more per non-terminal sweep.  A
subset boundary of the graph loop makes no read of its own (no
``.item()``, ``bool()`` or index by a 0-dim tensor).  Every such
blocking transfer goes through ``fetch`` and counts in
``RunStats.host_round_trips`` (the port's own number, not the reference's).

Because the peel-set size is read anyway, every CD gather is sized to it
(``bucket(n_peel, bj)``): the reference's fixed peel buffer, its overflow
flag and the host replay of an overflowed sweep never arise here, so
neither ``_MAX_OVERFLOW_REPLAYS`` nor the graph dispatch's replay view of
the carried matrix (the reference's ``_GraphStateView``) has a
counterpart, and ``RunStats.overflow_fallbacks`` stays 0.

Support updates go through the kernel entry points of
``repro_torch.kernels.ops`` — kernel 1 (``butterfly_update``; kernel 4 on
the sparse backends, with the staircase extents ``row_ext``/``kmax``) for
the single-graph loops, kernel 2 (kernel 5 on the sparse backends) and
kernel 3 (``b2_stack``) for the batched loop.

**The edge axis** (wing peeling, DESIGN.md section 10) plugs into the same
loops through ``DELTA_RULES``: the support vector is per EDGE SLOT, the
geometry ``{"a", "eu", "ev"}`` carries the residual biadjacency (peeling
rewrites it), and a sweep either recounts every survivor in closed form
(``kernels.ops.edge_support_all``) or applies the before-minus-after
delta of the peeled set (``kernels.ops.edge_support_delta``), by the
reference's HUC rule.  The edge HUC choice compares host values (the
peel-set size read anyway against ``c_rcnt``), so an edge sweep costs one
read, as a level sweep does.

Exactness (DESIGN.md section 8, the port's paragraph): supports, theta,
the CD bounds and the B2 entries are float64 integers (``SUPPORT_DTYPE``),
exact below ``EXACT_LIMIT`` = 2^53, where the reference's float32 stops at
2^24; the kernels return float64 from ``C(W, 2)`` on.  The sweep scalars
(``hi``, ``lo``, the caps) take the dtype of the supports they compare
with, so the edge axis and the tiled path, which stay float32, are
unchanged.  The wedge counts and the f32 wedge/covered accumulators move
bounds and HUC choices, never a support, and stay float32.  The routes
left in float32 (kernel 6's tiled path, the mesh FD) are exact below
``F32_EXACT_LIMIT`` = 2^24; ``exact_limit`` names each route's limit and
``check_exact`` refuses a counted support at or past it.  PyTorch may run
a float32 matrix product on the tensor
cores with TF32 inputs (``torch.set_float32_matmul_precision("high")``),
which hold integers exactly only up to 2048.  The engine's products of two
0/1 operands (``dv``, column sums) are exact that way too, since the
products accumulate in f32; the ones with a larger operand — the residual
wedge counts ``w = a @ max(dv - 1, 0)`` (``residual_wedges``) and the B2
row reductions of the FD level loop — are written as elementwise products
and sums, so they stay full float32 whatever the global setting.  ``c_peel``
and ``c_rcnt`` are elementwise already.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ...kernels import butterfly_sparse as ksparse
from ...kernels import ops as kops
from ...utils.spans import RunTrace, span
from ..graph import BipartiteGraph

__all__ = [
    "ReceiptConfig",
    "RunStats",
    "bucket",
    "cd_gather_width",
    "peel_delta",
    "DELTA_RULES",
    "DeltaRule",
    "fetch",
    "upload",
    "resolve_device",
    "DeviceGraph",
    "device_peel_loop",
    "device_cd_graph_loop",
    "cd_graph_state0",
    "batched_level_loop",
    "host_sweep",
    "support_all",
    "support_delta",
    "residual_dv",
    "residual_wedges",
    "apply_delta",
    "level_threshold",
    "select_peel",
    "record_theta",
    "peel_cost",
    "SUPPORT_DTYPE",
    "EXACT_LIMIT",
    "F32_EXACT_LIMIT",
    "exact_limit",
    "check_exact",
    "note_wide",
]

_INF = float("inf")
_F32 = torch.float32

# The exactness limits (DESIGN.md section 8, the port's paragraph).  The
# supports, theta, the bounds and the B2 entries are float64 integers on
# every route but the two below: every value below 2^53 is exact, and the
# atomics' order cannot change a sum of integers below it.  Kernel 6 (the
# tiled representation) and the mesh FD's sharded stacks keep float32
# supports: exact below 2^24.  The graph dispatch's device findHi prefix
# sums and its on-device ``c_rcnt`` stay float32 on every route: they move
# subset bounds and HUC choices, never a support (Theorem 1 holds for any
# bounds).
SUPPORT_DTYPE = torch.float64
EXACT_LIMIT = 2 ** 53
F32_EXACT_LIMIT = 2 ** 24


def exact_limit(representation: str = "dense", mesh=None) -> int:
    """The exact limit of a route: ``F32_EXACT_LIMIT`` on the tiled
    representation and on a mesh FD, ``EXACT_LIMIT`` on every other."""
    if representation == "tiled" or mesh is not None:
        return F32_EXACT_LIMIT
    return EXACT_LIMIT


def check_exact(stats, top: float, limit: int, **context) -> None:
    """Record ``top``, the largest counted support of the run, as
    ``stats.trace.max_support``, and refuse the run when it reaches
    ``limit`` (``exact_limit``): ``PlanInfeasibleError`` with
    ``dispatch="decompose"`` and ``context``.  ``top`` comes from a read
    the caller makes anyway; this makes none."""
    from ...api.errors import PlanInfeasibleError

    if stats is not None:
        stats.trace.max_support = max(stats.trace.max_support, float(top))
    if top >= limit:
        raise PlanInfeasibleError(
            f"a counted butterfly support reaches {top:.0f}, at or past "
            f"this route's exact limit {limit} (DESIGN.md section 8): its "
            "tip numbers would not be exact; run the dense representation "
            "on one device (exact below 2^53)",
            dispatch="decompose", max_support=float(top), exact_limit=limit,
            **context)


def note_wide(stats, *tensors):
    """Count the bytes of the float64 ``tensors`` (supports, deltas,
    theta, bounds, B2 stacks) the run allocates in
    ``stats.trace.wide_bytes``; returns the first."""
    if stats is not None:
        stats.trace.wide_bytes += sum(
            t.numel() * t.element_size() for t in tensors
            if t.dtype == torch.float64)
    return tensors[0]


# ---------------------------------------------------------------------- #
# config / stats
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class ReceiptConfig:
    """The engine's knobs: the same fields, defaults and validation as the
    reference's ``ReceiptConfig`` (see its field comments there).  The
    reference's backend names are mapped by ``convert.config_from_fields``.
    """

    num_partitions: int = 8                  # P
    backend: Optional[str] = None            # "cuda" | "torch" | None (auto)
    kernel_blocks: Tuple[int, int, int] = (128, 128, 512)
    use_huc: bool = True
    use_dgm: bool = True                     # host DGM re-induction per
    #   subset boundary, gated by dgm_row_threshold
    degree_sort: bool = True                 # Wang et al. relabel (tile density)
    dgm_row_threshold: float = 0.7           # re-induce when alive < thresh*rows
    fd_mode: str = "level"                   # "level" (batched level-peel)
    #                                        # | "b2" | "matvec" (legacy seq)
    cd_dispatch: str = "subset"              # "subset" | "graph"
    dtype: Any = torch.float32
    max_sweeps: int = 100_000                # valve: bounds ONE loop invocation
    device_loop: bool = True                 # device sweep loop (False: the
    #                                        # host-driven host_sweep engine)
    peel_width: Optional[int] = None         # FD gather buffer (None = probe)
    fd_overlap: bool = True                  # double-buffered FD group dispatch
    fd_update_mode: str = "auto"             # "auto" | "b2" | "kernel"
    fd_b2_cells: int = 1 << 24               # B2-stack budget (G * M * M)
    representation: str = "dense"            # "dense" | "tiled" | "auto"
    tiled_regather_every: int = 1
    tiled_compact_every: int = 64
    tiled_compact_ratio: float = 0.5
    fd_prepeel_levels: int = 4               # support levels the FD host
    #                                        # pre-peel hoists per task

    def __post_init__(self):
        """Validate every knob at construction (the reference's floor)."""
        if self.num_partitions < 1:
            raise ValueError(
                f"num_partitions must be >= 1 (got {self.num_partitions})")
        kops.resolve_backend(self.backend)   # raises on unknown names
        blocks = tuple(self.kernel_blocks)
        if len(blocks) != 3 or any(int(b) < 1 for b in blocks):
            raise ValueError(
                f"kernel_blocks must be three positive tile sizes "
                f"(bi, bj, bk), got {self.kernel_blocks!r}")
        if self.backend in kops.SPARSE_BACKENDS and blocks[0] != blocks[1]:
            raise ValueError(
                f"sparse backends require square row tiles (bi == bj), "
                f"got kernel_blocks={self.kernel_blocks!r}")
        if self.fd_mode not in ("level", "b2", "matvec"):
            raise ValueError(
                f"unknown fd_mode {self.fd_mode!r}: expected 'level', "
                "'b2' or 'matvec'")
        if self.cd_dispatch not in ("subset", "graph"):
            raise ValueError(
                f"unknown cd_dispatch {self.cd_dispatch!r}: expected "
                "'subset' or 'graph'")
        if self.cd_dispatch == "graph" and not self.device_loop:
            raise ValueError(
                "cd_dispatch='graph' runs the whole CD phase on device "
                "and requires device_loop=True")
        if self.fd_update_mode not in ("auto", "b2", "kernel"):
            raise ValueError(
                f"unknown fd_update_mode {self.fd_update_mode!r}: "
                "expected 'auto', 'b2' or 'kernel'")
        if self.max_sweeps < 1:
            raise ValueError(
                f"max_sweeps must be >= 1 (got {self.max_sweeps}): the "
                "valve bounds one device-loop invocation; a sub-1 cap "
                "can make no progress")
        if self.peel_width is not None and self.peel_width < 1:
            raise ValueError(
                f"peel_width must be >= 1 or None (got {self.peel_width})")
        if not (0.0 < self.dgm_row_threshold <= 1.0):
            raise ValueError(
                f"dgm_row_threshold must lie in (0, 1] (got "
                f"{self.dgm_row_threshold}): it is the alive-row fraction "
                "below which the subset dispatch re-induces")
        if self.fd_b2_cells < 1:
            raise ValueError(
                f"fd_b2_cells must be >= 1 (got {self.fd_b2_cells})")
        if self.representation not in ("dense", "tiled", "auto"):
            raise ValueError(
                f"unknown representation {self.representation!r}: expected "
                "'dense', 'tiled' or 'auto'")
        if self.tiled_regather_every < 1:
            raise ValueError(
                f"tiled_regather_every must be >= 1 "
                f"(got {self.tiled_regather_every})")
        if self.tiled_compact_every < 1:
            raise ValueError(
                f"tiled_compact_every must be >= 1 "
                f"(got {self.tiled_compact_every})")
        if self.tiled_compact_ratio > 1.0:
            raise ValueError(
                f"tiled_compact_ratio must be <= 1 (got "
                f"{self.tiled_compact_ratio}): it is an alive-row "
                "fraction (<= 0 disables host recompaction)")
        if self.fd_prepeel_levels < 1:
            raise ValueError(
                f"fd_prepeel_levels must be >= 1 (got "
                f"{self.fd_prepeel_levels}): the FD pre-peel always "
                "hoists at least the first support level")


@dataclasses.dataclass
class RunStats:
    """The paper's evaluation counters (Table 3 / Figs 5-9): the same
    fields as the reference's ``RunStats``.  ``dataclasses.asdict`` gives
    the plain-dict form.

    ``host_round_trips`` counts this port's blocking device->host
    transfers; ``device_loop_calls`` counts peel-loop invocations;
    ``overflow_fallbacks`` stays 0 (see the module docstring).

    The phase times are host ``perf_counter`` seconds.  On the subset
    dispatch each ends in a blocking read, so it holds the device work
    it launched: ``time_count`` ends in the ``fetch`` of the counted
    supports, ``time_cd`` after the last ``fetch`` of the sweep loop (a
    DGM re-induction is always followed by more sweeps), and ``time_fd``
    with theta on the host (each group's drain ends in its ``fetch``).
    On the graph dispatch ``time_count`` ends when the count is launched;
    its device time is charged to ``time_cd``, which ends in the final
    ``fetch``.

    ``trace`` (a ``utils.spans.RunTrace``, a plain attribute and not a
    field, so ``asdict`` and ``==`` leave it out) holds the run's span
    seconds and calls by name (``utils.spans.span``) and its host-to-card
    uploads (``upload``).
    """

    rho_cd: int = 0                 # CD sync rounds (peel sweeps)
    rho_fd: int = 0                 # FD peel sweeps
    sweeps_per_subset: List[int] = dataclasses.field(default_factory=list)
    wedges_pvbcnt: int = 0          # counting bound sum_E min(du, dv)
    wedges_cd: int = 0              # wedges traversed peeling in CD
    wedges_fd: int = 0              # wedges traversed in FD
    huc_recounts: int = 0
    dgm_compactions: int = 0        # host DGM re-inductions (subset dispatch)
    dgm_device_compactions: int = 0  # on-device DGM (graph dispatch)
    elided_sweeps: int = 0          # terminal-sweep elision (beyond-paper)
    num_subsets: int = 0
    bounds: List[int] = dataclasses.field(default_factory=list)
    subset_sizes: List[int] = dataclasses.field(default_factory=list)
    subset_wedges_fd: List[int] = dataclasses.field(default_factory=list)
    host_round_trips: int = 0       # blocking device->host transfers
    device_loop_calls: int = 0      # peel-loop invocations
    overflow_fallbacks: int = 0     # always 0 in the port
    fd_groups: int = 0              # FD shape groups dispatched
    fd_padding_waste: float = 0.0   # 1 - used/(padded) cells of FD stacks
    fd_peel_widths: List[int] = dataclasses.field(default_factory=list)
    fd_max_levels: List[int] = dataclasses.field(default_factory=list)
    fd_mask_fallbacks: int = 0      # groups whose largest level exceeded
    #                               # the gather buffer (mask-form update)
    fd_shards: int = 0
    fd_shard_rho: List[int] = dataclasses.field(default_factory=list)
    fd_shard_wedges: List[float] = dataclasses.field(default_factory=list)
    time_count: float = 0.0
    time_cd: float = 0.0
    time_fd: float = 0.0
    backend_used: str = ""
    backend_fallbacks: List[str] = dataclasses.field(default_factory=list)
    quarantined: bool = False
    straggler: bool = False
    verified: bool = False
    verify_checks: int = 0
    refresh_mode: str = ""
    refresh_t_hi: float = 0.0
    refresh_stop: float = 0.0
    refresh_subsets_repeeled: int = 0
    refresh_subsets_total: int = 0
    refresh_dirty_edges: int = 0

    def __post_init__(self):
        self.trace = RunTrace()

    @property
    def wedges_total(self) -> int:
        return self.wedges_pvbcnt + self.wedges_cd + self.wedges_fd


# ---------------------------------------------------------------------- #
# small helpers
# ---------------------------------------------------------------------- #
def bucket(n: int, block: int) -> int:
    """Power-of-two-ish bucket >= n, multiple of ``block``."""
    b = block
    while b < n:
        b *= 2
    return b


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Raises when the card is asked for and there is none —
    nothing carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card unless the "
            "caller passes device='cpu'")
    return dev


def fetch(stats: Optional[RunStats], *tensors) -> List[np.ndarray]:
    """Bring ``tensors`` to the host in ONE blocking transfer (packed as
    float64, which holds every f32, int32 and bool value exactly) and
    count it in ``stats.host_round_trips``.

    The span ``read`` times the call: the wait for the work queued
    before it, and the copy."""
    with span("read", stats):
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
        host = flat.cpu().numpy()
    if stats is not None:
        stats.host_round_trips += 1
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[at: at + n].reshape(tuple(t.shape)))
        at += n
    return out


def upload(stats: Optional[RunStats], array, device,
           dtype=None) -> torch.Tensor:
    """``array`` (numpy) on ``device``, cast to ``dtype`` when given: the
    same copy as ``torch.as_tensor(array).to(...)`` (pageable, no sync).
    Counts its ``nbytes`` and one upload in ``stats.trace``, and a float64
    result's bytes in ``wide_bytes`` (``note_wide``)."""
    array = np.asarray(array)
    if stats is not None:
        stats.trace.upload_bytes += int(array.nbytes)
        stats.trace.uploads += 1
    t = torch.as_tensor(array)
    t = t.to(device) if dtype is None else t.to(device=device, dtype=dtype)
    return note_wide(stats, t)


def _f32_scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=device)


def _scalar(x, like) -> torch.Tensor:
    """``x`` (a number or tensor) in the dtype and on the device of
    ``like``: a sweep's bound or cap beside the supports it compares
    with."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _masked_rows_sum(m, mask):
    """``mask @ m`` over the row axis (second to last) as a masked sum in
    ``m``'s dtype (the B2 rows: float64), whatever the global TF32
    setting."""
    return (m * mask.to(m.dtype).unsqueeze(-1)).sum(dim=-2)


# ---------------------------------------------------------------------- #
# device primitives
# ---------------------------------------------------------------------- #
def support_all(a, alive, ids, kmax, *, backend, blocks, stats=None):
    """HUC recount / initial count: support of every row w.r.t. alive rows
    (``kmax`` the row-tile extents on the sparse backends, else None);
    float64, counted in ``stats.trace.wide_bytes``."""
    return note_wide(stats, kops.butterfly_update(
        a, a, alive.to(a.dtype), ids, ids, backend=backend, blocks=blocks,
        kmax_a=kmax, kmax_b=kmax, body="count"))


def support_delta(a, a_peel, valid, ids, ids_peel, kmax_a, kmax_b, *,
                  backend, blocks, stats=None):
    """CD peel update: delta[u'] = sum_{u in S} C(W[u, u'], 2) (float64,
    counted in ``stats.trace.wide_bytes``)."""
    return note_wide(stats, kops.butterfly_update(
        a, a_peel, valid.to(a.dtype), ids, ids_peel, backend=backend,
        blocks=blocks, kmax_a=kmax_a, kmax_b=kmax_b))


def residual_dv(a, alive):
    """Residual V degrees of the alive rows (a product of 0/1 operands:
    exact in f32 and in TF32 alike)."""
    return alive.to(a.dtype) @ a


def residual_wedges(a, dv):
    """Per-row residual wedge counts ``a @ max(dv - 1, 0)``, as an
    elementwise product and a sum: ``dv`` may pass 2048, so a TF32 matrix
    product would round it."""
    return (a * torch.clamp(dv - 1.0, min=0.0).unsqueeze(-2)).sum(dim=-1)


# ---------------------------------------------------------------------- #
# shared sweep-body pieces (last-axis semantics; leading dims broadcast,
# so the SAME code runs shape-(M,) single-graph and shape-(G, M) batched)
# ---------------------------------------------------------------------- #
def level_threshold(support, alive, lo):
    """Min-peel threshold: cap = max(min alive support, lo), hi = cap + 1,
    in the supports' dtype.

    Dead batch members yield cap = inf, which makes every downstream piece
    a no-op.
    """
    mn = torch.where(alive, support, _INF).amin(dim=-1)
    cap = torch.maximum(mn, _scalar(lo, support))
    return cap + 1.0, cap


def select_peel(support, alive, hi):
    """Peel set of one sweep: alive rows with support below ``hi``."""
    hi = _scalar(hi, support)
    return alive & (support < hi.unsqueeze(-1))


def apply_delta(support, alive, peel, delta, lo):
    """Alg. 2 update with the Alg. 3 range cap: cap at theta(i) = lo."""
    alive_after = alive & ~peel
    cap = _scalar(lo, support).unsqueeze(-1)
    sup = torch.where(alive_after, torch.maximum(support - delta, cap),
                      support)
    return sup, alive_after


def record_theta(theta, peel, cap):
    """Min-peel theta recording: every peeled row gets the sweep's cap."""
    return torch.where(peel, cap.unsqueeze(-1), theta)


def peel_cost(colsum, dv):
    """Dynamic wedge cost of a peel set from its column sums:
    C_peel = colsum_S . max(dv - 1, 0)."""
    return (colsum * torch.clamp(dv - 1.0, min=0.0)).sum(dim=-1)


def cd_gather_width(rows_pad: int, block_rows: int) -> int:
    """The widest gather of a single-graph peel update: the reference's
    initial CD peel width (``ExecutionPlan.cd_peel_width0``).  A peel set
    wider than this is updated in chunks of it (``peel_delta``), so no
    sweep holds more than a (width, n_v) gather: the bound the Planner's
    memory estimate counts."""
    return min(bucket(max(block_rows, rows_pad // 4), block_rows), rows_pad)


def _gather_peel(a, order, n: int, width: int):
    """Rows ``order[:n]`` of ``a`` gathered into one (width, n_v) buffer,
    padding rows zeroed in place; returns (rows int32, valid bool,
    a_peel)."""
    valid = torch.arange(width, device=a.device) < n
    rows = torch.zeros(width, dtype=torch.int32, device=a.device)
    rows[:n] = order[:n]
    a_peel = a.index_select(0, rows)
    a_peel[n:] = 0.0
    return rows, valid, a_peel


def peel_delta(a, peel, n_peel: int, ids, row_ext, kmax, *, backend,
               blocks, stats=None):
    """The peel update ``delta[u'] = sum_{u in S} C(W[u, u'], 2)`` of the
    peel set ``S`` (``n_peel`` rows, read by the caller): its rows
    gathered in row order (a stable sort puts them first) and handed to
    kernel 1's peel body (kernel 4's on the sparse backends, with the
    gathered rows' tile extents), ``cd_gather_width`` rows per call; the
    chunks' deltas are summed (float64 integers below 2^53: exact)."""
    sparse = backend in kops.SPARSE_BACKENDS
    chunk = cd_gather_width(a.shape[0], blocks[1])
    order = torch.argsort((~peel).to(torch.int8), stable=True)[:n_peel]
    delta = None
    for start in range(0, n_peel, chunk):
        n = min(chunk, n_peel - start)
        width = min(bucket(n, blocks[1]), a.shape[0])
        rows, valid, a_peel = _gather_peel(a, order[start:], n, width)
        kb = (ksparse.gathered_tile_extents(row_ext, rows, valid, blocks[1])
              if sparse else None)
        d = support_delta(a, a_peel, valid, ids, rows,
                          kmax if sparse else None, kb, backend=backend,
                          blocks=blocks, stats=stats)
        delta = d if delta is None else delta + d
        # dropped before the next chunk's gather: one gather on the card
        del rows, valid, a_peel, kb
    return delta


def _peel_sizes(support, alive, hi, stats):
    """A sweep's peel set and the one read it costs: (peel, n_peel,
    n_alive), the two sizes fetched in a single transfer."""
    peel = select_peel(support, alive, hi)
    n_peel, n_alive = (int(x) for x in fetch(stats, peel.sum(), alive.sum()))
    return peel, n_peel, n_alive


# ---------------------------------------------------------------------- #
# one sweep of the single-graph loops
# ---------------------------------------------------------------------- #
def _sweep_once(a, ids, row_ext, kmax, c_rcnt, cap, support, alive, dv,
                wedges, covered, peel, n_peel, n_alive, *, backend, blocks,
                use_huc, stats, widths=None):
    """One non-empty peel sweep (reference ``_sweep_once``, vertex axis),
    shared by ``device_peel_loop`` and ``device_cd_graph_loop``: the
    terminal-sweep elision, the HUC peel-vs-recount choice, the peel
    update over gathers sized to the peel set (``peel_delta``) and the
    incremental residual-degree / wedge counter updates.  The caller has
    selected ``peel`` and read its sizes (``_peel_sizes``), and records
    theta / the peeled set itself.  ``widths`` (a list, or None) gets the
    row count of the sweep's widest gather.

    ``row_ext`` / ``kmax`` are the per-row and row-tile staircase extents
    of ``a`` (read on the sparse backends only); ``c_rcnt`` is the HUC
    recount bound as an f32 tensor.  Returns (support, alive, dv, wedges,
    covered, recounted, elided).
    """
    sparse = backend in kops.SPARSE_BACKENDS
    if n_peel == n_alive:
        # terminal-sweep elision: a sweep that peels EVERY survivor needs
        # no update kernel; the full peel set's column sums are dv itself
        return (support, alive & ~peel, torch.zeros_like(dv), wedges,
                covered + peel_cost(dv, dv), False, True)

    if widths is not None:
        widths.append(min(bucket(n_peel, blocks[1]),
                          cd_gather_width(a.shape[0], blocks[1])))
    # incremental residual degrees: peeled rows' column sums (a product
    # of 0/1 operands: exact in f32 and TF32 alike)
    colsum = peel.to(a.dtype) @ a
    c_peel = peel_cost(colsum, dv)
    use_rec = use_huc and bool(fetch(stats, c_peel > c_rcnt)[0])
    if use_rec:
        alive2 = alive & ~peel
        s2 = support_all(a, alive2, ids, kmax if sparse else None,
                         backend=backend, blocks=blocks, stats=stats)
        support2 = torch.where(alive2, torch.maximum(s2, cap), _INF)
        wedges = wedges + c_rcnt
    else:
        delta = peel_delta(a, peel, n_peel, ids, row_ext, kmax,
                           backend=backend, blocks=blocks, stats=stats)
        s2, alive2 = apply_delta(support, alive, peel, delta, cap)
        support2 = torch.where(alive2, s2, _INF)
        wedges = wedges + c_peel
    return (support2, alive2, dv - colsum, wedges, covered + c_peel, use_rec,
            False)


def _zero_edges(a, eu, ev, peel):
    """Zero the peeled edge slots' cells of ``a`` IN PLACE (a (R, C)
    matrix with ``peel`` (E,), or a stack (G, R, C) with (G, E)) and
    return the peeled edges' column hits (padding slots alias cell
    (0, 0) with peel False, so they remove and add nothing)."""
    kops.zero_cells_(a, eu, ev, peel)
    colsum = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=_F32,
                         device=a.device)
    if a.dim() == 3:
        gidx = torch.arange(a.shape[0], device=a.device)[:, None]
        colsum.index_put_((gidx, ev), peel.to(_F32), accumulate=True)
    else:
        colsum.index_put_((ev,), peel.to(_F32), accumulate=True)
    return colsum


def _sweep_once_edge(geom, c_rcnt, cap, support, alive, dv, wedges, covered,
                     peel, n_peel, n_alive, *, backend, blocks, use_huc,
                     peel_width):
    """One non-empty edge-axis sweep (reference ``_sweep_once_edge``).

    ``support``/``alive``/``peel`` are per edge slot, ``dv`` the residual
    V degrees, ``geom = {"a", "eu", "ev"}`` the residual biadjacency and
    the slot endpoints (``eu``/``ev`` int64); the peeled edges are zeroed
    out of ``geom["a"]`` IN PLACE.  A sweep that peels every survivor is
    elided; otherwise the reference's HUC rule picks the update:
    ``use_huc`` recounts when the peel set passes the reference's gather
    width ``peel_width`` or ``n_peel > c_rcnt`` (compared in f32, as the
    reference does), else applies the peel set's delta, before-minus-after
    of the closed form (``kernels.ops.edge_support_delta``'s computation,
    the after-count being the recount's); ``use_huc=False`` always
    recounts (policy, not counted in ``hucs``).  ``c_rcnt`` is a host
    float; ``wedges``/``covered`` f32 device scalars.

    Returns (geom, support, alive, dv, wedges, covered, recounted,
    elided).
    """
    a, eu, ev = geom["a"], geom["eu"], geom["ev"]
    if n_peel == n_alive:
        colsum = _zero_edges(a, eu, ev, peel)
        return (geom, support, alive & ~peel, dv - colsum, wedges,
                covered + float(n_peel), False, True)
    if use_huc:
        rec = (n_peel > peel_width
               or np.float32(n_peel) > np.float32(c_rcnt))
    else:
        rec = True
    before = (None if rec else
              kops.edge_support_all(a, eu, ev, backend=backend,
                                    blocks=blocks))
    colsum = _zero_edges(a, eu, ev, peel)
    after = kops.edge_support_all(a, eu, ev, backend=backend, blocks=blocks)
    alive2 = alive & ~peel
    if rec:
        support2 = torch.where(alive2, torch.maximum(after, cap), _INF)
        wedges = wedges + np.float32(c_rcnt).item()
    else:
        s2, alive2 = apply_delta(support, alive, peel, before - after, cap)
        support2 = torch.where(alive2, s2, _INF)
        wedges = wedges + float(n_peel)
    return (geom, support2, alive2, dv - colsum, wedges,
            covered + float(n_peel), rec and use_huc, False)


@dataclasses.dataclass(frozen=True)
class DeltaRule:
    """One peel axis of the engine (reference ``DeltaRule``): whether a
    sweep rewrites the carried geometry (edge peeling deletes matrix
    entries; vertex peeling only masks rows).  The loops branch on it to
    their axis's sweep body (``_sweep_once`` / ``_sweep_once_edge``)."""

    axis: str
    mutable_geom: bool


DELTA_RULES = {
    "vertex": DeltaRule(axis="vertex", mutable_geom=False),
    "edge": DeltaRule(axis="edge", mutable_geom=True),
}


# ---------------------------------------------------------------------- #
# single-graph sweep loop (CD range-peel / min-peel)
# ---------------------------------------------------------------------- #
def device_peel_loop(a, ids, support, alive, dv, theta, hi, lo, c_rcnt,
                     sweeps0=0, *, backend, blocks, use_huc, max_sweeps,
                     minmode, row_ext=None, kmax=None, stats=None,
                     widths=None, axis="vertex", peel_width=None):
    """Run an entire peel-sweep loop over device tensors.

    * ``minmode=False`` (RECEIPT CD, Alg. 3): peel everything with
      support < ``hi`` until the range drains; support updates cap at
      ``lo`` = theta(i).
    * ``minmode=True`` (ParB schedule): each sweep peels the current
      minimum-support level; ``hi``/``cap`` are recomputed per sweep as
      ``level_threshold(support, alive, lo)`` and ``theta`` records the
      peel value.  HUC is off in this mode, as in the reference.

    Residual V-degrees ``dv`` are maintained incrementally.  The
    ``max_sweeps`` valve bounds ONE invocation, never the schedule: the
    callers re-enter on a cap-exit with peelable rows left.  ``hi``,
    ``lo`` and the caps take the supports' dtype.  ``row_ext`` /
    ``kmax`` are ``a``'s staircase extents, required on the sparse
    backends.  ``widths`` (a list, or None) gets each gather's row count.

    Returns (support, alive, dv, theta, peeled, rho, wedges, hucs, elided,
    covered, sweeps, overflow) like the reference; ``wedges`` and
    ``covered`` are f32 device scalars (exact below 2^24), the counts are
    Python ints and ``overflow`` is always False.

    ``axis="edge"`` runs the edge rule (``DELTA_RULES``): ``a`` is the
    geometry dict ``{"a", "eu", "ev"}``, ``peel_width`` the reference's
    gather width (its HUC rule reads it), ``ids``/``row_ext``/``kmax``
    are unused, and the return tuple gains the updated geometry in
    front, as the reference's.
    """
    if DELTA_RULES[axis].mutable_geom:
        return _device_peel_loop_edge(
            a, support, alive, dv, theta, hi, lo, c_rcnt, sweeps0,
            backend=backend, blocks=blocks, use_huc=use_huc,
            max_sweeps=max_sweeps, minmode=minmode, peel_width=peel_width,
            stats=stats)
    dev = support.device
    hi = _scalar(hi, support)
    lo = _scalar(lo, support)
    c_rcnt = _f32_scalar(c_rcnt, dev)
    peeled = torch.zeros_like(alive)
    wedges = torch.zeros((), dtype=_F32, device=dev)
    covered = torch.zeros((), dtype=_F32, device=dev)
    rho = hucs = elided = 0
    sweeps = int(sweeps0)
    while sweeps < max_sweeps:
        if minmode:
            hi_cur, cap = level_threshold(support, alive, lo)
        else:
            hi_cur, cap = hi, lo
        peel, n_peel, n_alive = _peel_sizes(support, alive, hi_cur, stats)
        if n_peel == 0:
            break
        if minmode:
            theta = record_theta(theta, peel, cap)
        peeled = peeled | peel
        support, alive, dv, wedges, covered, rec, eli = _sweep_once(
            a, ids, row_ext, kmax, c_rcnt, cap, support, alive, dv, wedges,
            covered, peel, n_peel, n_alive, backend=backend, blocks=blocks,
            use_huc=(use_huc and not minmode), stats=stats, widths=widths)
        rho += 1
        hucs += int(rec)
        elided += int(eli)
        sweeps += 1
    return (support, alive, dv, theta, peeled, rho, wedges, hucs, elided,
            covered, sweeps, False)


def _device_peel_loop_edge(geom, support, alive, dv, theta, hi, lo, c_rcnt,
                           sweeps0, *, backend, blocks, use_huc, max_sweeps,
                           minmode, peel_width, stats):
    """The edge-axis ``device_peel_loop`` (reference ``axis="edge"``
    branch): one read per sweep (the peel-set and alive sizes), the HUC
    choice on the host.  Returns (geom, support, alive, dv, theta,
    peeled, rho, wedges, hucs, elided, covered, sweeps, overflow)."""
    dev = support.device
    hi = _scalar(hi, support)
    lo = _scalar(lo, support)
    peeled = torch.zeros_like(alive)
    wedges = torch.zeros((), dtype=_F32, device=dev)
    covered = torch.zeros((), dtype=_F32, device=dev)
    rho = hucs = elided = 0
    sweeps = int(sweeps0)
    while sweeps < max_sweeps:
        if minmode:
            hi_cur, cap = level_threshold(support, alive, lo)
        else:
            hi_cur, cap = hi, lo
        peel, n_peel, n_alive = _peel_sizes(support, alive, hi_cur, stats)
        if n_peel == 0:
            break
        if minmode:
            theta = record_theta(theta, peel, cap)
        peeled = peeled | peel
        geom, support, alive, dv, wedges, covered, rec, eli = \
            _sweep_once_edge(
                geom, c_rcnt, cap, support, alive, dv, wedges, covered,
                peel, n_peel, n_alive, backend=backend, blocks=blocks,
                use_huc=(use_huc and not minmode), peel_width=peel_width)
        rho += 1
        hucs += int(rec)
        elided += int(eli)
        sweeps += 1
    return (geom, support, alive, dv, theta, peeled, rho, wedges, hucs,
            elided, covered, sweeps, False)


# ---------------------------------------------------------------------- #
# whole-graph CD loop (every subset, boundaries on the device)
# ---------------------------------------------------------------------- #
def cd_graph_state0(dg: "DeviceGraph", support, alive, p_total: int) -> dict:
    """Initial state of ``device_cd_graph_loop`` (reference
    ``cd_graph_state0``).

    Tensors stay on the device; the loop's counters and control fields
    (``i``, ``rho``, ``hucs``, ``elided``, ``dgm``, ``iters``, ``done``,
    ``rho_sub``) are host values, because the host drives the loop anyway.
    ``hi = -inf`` makes the first iteration a boundary, which opens subset
    0 on the device.  The residual graph rides in the state (``a``, ``dv``,
    ``row_ext``/``kmax``, ``c_rcnt``): the on-device DGM step rewrites
    them.  ``init_sup``, ``bounds``, ``hi`` and ``lo`` take the supports'
    dtype; the findHi target and the wedge counters stay float32.
    ``_receipt_cd_graph`` re-enters with the returned state after a
    ``max_iters`` cap-exit, resetting only ``iters``.
    """
    dev = support.device
    rows_pad = dg.rows_pad
    return dict(
        a=dg.a, dv=dg.dv0, row_ext=dg.row_ext, kmax=dg.kmax,
        c_rcnt=_f32_scalar(dg.c_rcnt, dev), dgm=0,
        support=support, alive=alive,
        subset_of=torch.full((rows_pad,), -1, dtype=torch.int32, device=dev),
        init_sup=torch.zeros(rows_pad, dtype=support.dtype, device=dev),
        bounds=torch.zeros(p_total + 1, dtype=support.dtype, device=dev),
        rho_sub=[], i=-1,
        hi=_scalar(-_INF, support), lo=_scalar(0.0, support),
        scale=_f32_scalar(1.0, dev), tgt=_f32_scalar(0.0, dev),
        covered=_f32_scalar(0.0, dev), rho_start=0,
        rho=0, wedges=_f32_scalar(0.0, dev), hucs=0, elided=0,
        iters=0, done=False,
    )


def _compact_residual(st: dict, blocks, sparse: bool) -> dict:
    """On-device DGM (reference ``device_cd_graph_loop`` boundary): zero
    the dead rows, gather the live columns (residual degree >= 2) into a
    prefix with a stable sort (the degree-sort order kept inside it),
    permute ``dv`` along, re-tighten the staircase extents and re-estimate
    the HUC bound ``c_rcnt = sum_E min(du, dv)`` on the compacted graph.
    Rows keep their places, so supports and subset stamps are untouched.
    ``st`` is updated in place, the old matrix dropped before the
    compacted one is masked, so the card holds at most two (R, C)
    matrices here."""
    a = st.pop("a")
    live_col = st["dv"] >= 2.0
    perm = torch.argsort((~live_col).to(torch.int8), stable=True)
    a2 = a.index_select(1, perm)
    del a                       # the state held the only other reference
    a2.mul_(st["alive"][:, None].to(a2.dtype))
    a2.mul_(live_col[perm][None, :].to(a2.dtype))
    dv = torch.where(live_col, st["dv"], 0.0)[perm]
    if sparse:
        row_ext, kmax = kops.tighten_extents_device(
            a2, live_col.sum(), block_rows=blocks[0], block_k=blocks[2])
    else:
        row_ext, kmax = st["row_ext"], st["kmax"]
    du = a2.sum(dim=1)
    c_rcnt = torch.minimum(du[:, None], dv[None, :]).mul_(a2).sum()
    st.update(a=a2, dv=dv, row_ext=row_ext, kmax=kmax, c_rcnt=c_rcnt)


def _graph_boundary(st: dict, done: bool, *, blocks, sparse, use_dgm,
                    p_total) -> None:
    """Close subset ``i`` (none on the first entry, i = -1) and, unless no
    row is alive, open subset ``i + 1``: on-device DGM, the ``init_sup``
    snapshot, fresh residual wedge counts ``w = a @ max(dv - 1, 0)`` and
    the next ``hi`` from ``find_hi_device``.  No host read; ``st`` is
    updated in place."""
    i = st["i"]
    st["iters"] += 1
    if i >= 0:
        st["bounds"][i + 1] = st["hi"]
        st["rho_sub"] = st["rho_sub"] + [st["rho"] - st["rho_start"]]
        if i < p_total - 1:
            st["scale"] = torch.where(
                st["covered"] > 0,
                torch.clamp(st["tgt"] / st["covered"], max=1.0), st["scale"])
        st["lo"] = st["hi"]
        if use_dgm:
            st["dgm"] += 1
    if done:
        st["done"] = True
        return
    if use_dgm:
        _compact_residual(st, blocks, sparse)
    i2 = i + 1
    st["init_sup"] = torch.where(st["alive"], st["support"], st["init_sup"])
    w = residual_wedges(st["a"], st["dv"])
    if i2 >= p_total - 1:
        # a fill on the device: a copy from the host would wait for it
        tgt = torch.full((), _INF, dtype=_F32, device=w.device)
    else:
        rem = torch.where(st["alive"], w, 0.0).sum()
        tgt = torch.clamp(rem / float(max(p_total - i2, 1)) * st["scale"],
                          min=1.0)
    st.update(i=i2, tgt=tgt,
              hi=kops.find_hi_device(st["support"], st["alive"], w, tgt),
              covered=torch.zeros_like(st["covered"]), rho_start=st["rho"])


def device_cd_graph_loop(ids, state: dict, *, backend, blocks, use_huc,
                         use_dgm, max_iters, p_total, stats=None,
                         widths=None) -> dict:
    """Run the whole CD phase — every subset — over device-resident state
    (reference ``device_cd_graph_loop``, DESIGN.md section 2.3).

    Each iteration is either a **sweep** (one ``_sweep_once`` at the
    carried ``hi``/``lo``, the peeled rows stamped with the open subset)
    or, when the sweep's size read finds the range drained, a **subset
    boundary** (``_graph_boundary``) that runs entirely on the card: close
    the subset (bound, sweep count, adaptive ``scale``), the on-device DGM
    compaction (``use_dgm``), the ``init_sup`` snapshot, the fresh residual
    wedge counts and ``find_hi_device``.  The same read says whether any
    row is alive, which ends the loop after the closing boundary.

    ``max_iters`` bounds one invocation (sweeps and boundaries); the caller
    re-enters with the returned state.  The column permutation of the
    compaction lives in the carried ``a`` (and ``dv``/``row_ext``/``kmax``),
    so everything after a boundary reads the carried matrix, never the
    construction-time ``DeviceGraph.a``.  Bounds may differ from the
    subset dispatch (fresh residual wedge counts, f32 findHi prefix sums,
    DGM at every boundary); tip numbers cannot (Theorem 1 holds for any
    bounds).  ``widths`` (a list, or None) gets each gather's row count.
    """
    sparse = backend in kops.SPARSE_BACKENDS
    st = state
    while not st["done"] and st["iters"] < max_iters:
        peel, n_peel, n_alive = _peel_sizes(st["support"], st["alive"],
                                            st["hi"], stats)
        if n_peel == 0:
            _graph_boundary(st, n_alive == 0, blocks=blocks, sparse=sparse,
                            use_dgm=use_dgm, p_total=p_total)
            continue
        support, alive, dv, wedges, covered, rec, eli = _sweep_once(
            st["a"], ids, st["row_ext"], st["kmax"], st["c_rcnt"], st["lo"],
            st["support"], st["alive"], st["dv"], st["wedges"],
            st["covered"], peel, n_peel, n_alive, backend=backend,
            blocks=blocks, use_huc=use_huc, stats=stats, widths=widths)
        st.update(
            support=support, alive=alive, dv=dv, wedges=wedges,
            covered=covered, rho=st["rho"] + 1,
            hucs=st["hucs"] + int(rec), elided=st["elided"] + int(eli),
            subset_of=torch.where(peel, st["i"], st["subset_of"]),
            iters=st["iters"] + 1)
    return st


# ---------------------------------------------------------------------- #
# batched level-peel loop (FD: a stack of independent subsets)
# ---------------------------------------------------------------------- #
def batched_level_loop(a, support, alive, dv, lo, *, backend, blocks,
                       peel_width, max_sweeps, update_mode="kernel",
                       row_ext=None, stats=None, eu=None, ev=None,
                       axis="vertex"):
    """Peel a stack of G independent subsets by whole support levels.

    Each sweep peels, in EVERY still-live group, the entire
    current-minimum support level (``level_threshold`` with the group's
    theta lower bound ``lo[g]``).

    a:       (G, M, C)  stacked induced biadjacencies (0/1)
    support: (G, M)     FD-initialized supports (+inf on padding rows)
    alive:   (G, M)     bool (False on padding rows)
    dv:      (G, C)     residual V-degrees of each induced subgraph
    lo:      (G,)       per-subset theta lower bounds (CD range floors)
    row_ext: (G, M)     int32 per-row staircase extents (sparse backends)

    The peel level is gathered into a fixed (G, ``peel_width``, C) buffer.
    A sweep where ANY group's level exceeds the buffer uses the mask form
    (B = A, s = peel mask) instead: same output, no gather.  The loop test
    and the largest level are read in one transfer per sweep.

    ``update_mode``: ``"kernel"`` streams every sweep through kernel 2
    (kernel 5 on the sparse backends, with per-group extents); ``"b2"``
    computes the (G, M, M) shared-butterfly stack ONCE with kernel 3
    (whose CUDA version masks ragged edges, so unlike the reference no
    block-alignment test routes around it) and reduces its gathered rows
    per sweep.  Both give bit-identical deltas (float64, as ``support``,
    ``lo`` and ``theta``).

    Returns (support, alive, dv, theta, rho, wedges, max_level, sweeps)
    as the reference does: ``theta`` (G, M) in the supports' dtype,
    per-group ``rho`` (int32), ``wedges`` (f32) and ``max_level`` (int32)
    tensors, ``sweeps`` int.

    ``axis="edge"`` (wing FD): ``support``/``alive`` are per edge slot
    (G, E), ``eu``/``ev`` the slots' endpoints (int64, (E,) or (G, E))
    into the stacked biadjacency, and every sweep zeroes the peeled level
    out of ``a`` (in place: the caller's stack is the carried one) and
    recounts every survivor in closed form (no gather, no update mode).
    Returns the reference's 9-tuple with the carried biadjacency in
    front: (a, support, alive, dv, theta, rho, wedges, max_level,
    sweeps); ``wedges`` counts peeled edges.
    """
    if DELTA_RULES[axis].mutable_geom:
        return _batched_level_loop_edge(
            a, support, alive, dv, lo, eu, ev, backend=backend,
            blocks=blocks, max_sweeps=max_sweeps, stats=stats)
    g_n, mm, _cc = a.shape
    dev = a.device
    sparse = backend in kops.SPARSE_BACKENDS
    lo = _scalar(lo, support)
    ids = torch.arange(mm, dtype=torch.int32, device=dev).expand(
        g_n, mm).contiguous()
    if sparse:
        kmax_a = ksparse.tile_extents(row_ext, blocks[0])
        kmax_mask = ksparse.tile_extents(row_ext, blocks[1])
    else:
        kmax_a = kmax_mask = None
    if update_mode == "b2":
        b2 = note_wide(stats, kops.b2_stack(a.to(_F32), backend=backend,
                                            blocks=blocks))
    elif update_mode != "kernel":
        raise ValueError(f"unknown update_mode {update_mode!r}")

    def full_mask_update(peel):
        """Full-width update: B = A, s = peel mask (no gather)."""
        if update_mode == "b2":
            delta = _masked_rows_sum(b2, peel)
        else:
            delta = note_wide(stats, kops.butterfly_update_batched(
                a, a, peel.to(a.dtype), ids, ids, backend=backend,
                blocks=blocks, kmax_a=kmax_a, kmax_b=kmax_mask))
        return delta, torch.einsum("gm,gmc->gc", peel.to(_F32),
                                   a.to(_F32))

    def gathered_update(peel, n_peel):
        """Gathered update: the peel level compacted to the fixed
        (G, peel_width, ...) buffer (a stable sort puts peel rows first),
        then kernel 2 against the gathered rows or a reduction of the
        precomputed B2 rows."""
        order = torch.argsort((~peel).to(torch.int8), dim=-1, stable=True)
        rows = order[:, :peel_width]
        valid = (torch.arange(peel_width, device=dev)[None, :]
                 < n_peel[:, None])
        a_peel = (torch.take_along_dim(a, rows[:, :, None], dim=1)
                  * valid[:, :, None].to(a.dtype))
        if update_mode == "b2":
            b2_rows = torch.take_along_dim(b2, rows[:, :, None], dim=1)
            delta = _masked_rows_sum(b2_rows, valid)
        else:
            kb = (ksparse.batched_gathered_tile_extents(row_ext, rows, valid,
                                                        blocks[1])
                  if sparse else None)
            delta = note_wide(stats, kops.butterfly_update_batched(
                a, a_peel, valid, ids, rows, backend=backend, blocks=blocks,
                kmax_a=kmax_a, kmax_b=kb))
        return delta, a_peel.to(_F32).sum(dim=1)

    theta = note_wide(stats, torch.zeros((g_n, mm), dtype=support.dtype,
                                         device=dev))
    rho = torch.zeros(g_n, dtype=torch.int32, device=dev)
    wedges = torch.zeros(g_n, dtype=_F32, device=dev)
    max_level = torch.zeros(g_n, dtype=torch.int32, device=dev)
    sweeps = 0
    while sweeps < max_sweeps:
        hi, cap = level_threshold(support, alive, lo)     # (G,), (G,)
        act = alive.any(dim=-1)                           # (G,)
        peel = select_peel(support, alive, hi)            # (G, M)
        n_peel = peel.sum(dim=-1)
        any_alive, max_peel = fetch(stats, act.any(), n_peel.max())
        if not any_alive:
            break
        if peel_width >= mm or max_peel > peel_width:
            delta, colsum = full_mask_update(peel)
        else:
            delta, colsum = gathered_update(peel, n_peel)
        c_peel = peel_cost(colsum, dv)                    # (G,)
        theta = record_theta(theta, peel, cap)
        support2, alive = apply_delta(support, alive, peel, delta, cap)
        support = torch.where(alive, support2, _INF)
        dv = dv - colsum
        rho = rho + act.to(torch.int32)
        wedges = wedges + torch.where(act, c_peel, 0.0)
        max_level = torch.maximum(max_level, n_peel.to(torch.int32))
        sweeps += 1
    return support, alive, dv, theta, rho, wedges, max_level, sweeps


def _batched_level_loop_edge(a, support, alive, dv, lo, eu, ev, *, backend,
                             blocks, max_sweeps, stats):
    """The edge-axis ``batched_level_loop`` (reference ``axis="edge"``
    branch): per sweep one read (which groups have an alive slot), the
    level zeroed out of ``a`` in place and a closed-form recount of the
    groups that had one (a drained group's supports are masked to +inf
    anyway, so the reference's recount of it is skipped)."""
    g_n = a.shape[0]
    dev = a.device
    lo = _scalar(lo, support)
    theta = torch.zeros(support.shape, dtype=_F32, device=dev)
    rho = torch.zeros(g_n, dtype=torch.int32, device=dev)
    wedges = torch.zeros(g_n, dtype=_F32, device=dev)
    max_level = torch.zeros(g_n, dtype=torch.int32, device=dev)
    sweeps = 0
    while sweeps < max_sweeps:
        act = alive.any(dim=-1)                           # (G,)
        live = np.flatnonzero(fetch(stats, act)[0])
        if not live.size:
            break
        hi, cap = level_threshold(support, alive, lo)     # (G,), (G,)
        peel = select_peel(support, alive, hi)            # (G, E)
        n_peel = peel.sum(dim=-1)
        colsum = _zero_edges(a, eu, ev, peel)
        theta = record_theta(theta, peel, cap)
        alive = alive & ~peel
        s2 = kops.edge_support_all(a, eu, ev, backend=backend,
                                   blocks=blocks, members=live.tolist())
        support = torch.where(alive, torch.maximum(s2, cap[:, None]), _INF)
        dv = dv - colsum
        rho = rho + act.to(torch.int32)
        wedges = wedges + torch.where(act, n_peel.to(_F32), 0.0)
        max_level = torch.maximum(max_level, n_peel.to(torch.int32))
        sweeps += 1
    return a, support, alive, dv, theta, rho, wedges, max_level, sweeps


# ---------------------------------------------------------------------- #
# device-graph container (bucketed, compacted view of the residual graph)
# ---------------------------------------------------------------------- #
def _residual_edges(g: BipartiteGraph, members: np.ndarray):
    """The residual graph of ``members``, as ``g.induced_on_u(members,
    min_degree_v=2)`` gives it, by masks and counts alone (no sort):
    (``eu``, ``ev``) int64 row and column ids, the column count and the
    columns' degrees.  Rows follow ``members``' order; columns are the V
    vertices with residual degree >= 2 (the DGM column compaction: a
    degree-<2 column cannot complete a wedge), numbered in ascending V
    order as ``np.unique`` would number them.  For ascending ``members``
    the edges come out in ``induced_on_u``'s (u, v) order too."""
    keep = np.zeros(g.n_u, dtype=bool)
    keep[members] = True
    sel = keep[g.edges_u]
    eu, ev = g.edges_u[sel], g.edges_v[sel]
    dv = np.bincount(ev, minlength=g.n_v)
    col = dv >= 2
    good = col[ev]
    u_map = np.full(g.n_u, -1, dtype=np.int64)
    u_map[members] = np.arange(len(members))
    v_map = np.cumsum(col) - 1
    return u_map[eu[good]], v_map[ev[good]], int(col.sum()), dv[col]


class DeviceGraph:
    """Bucket-padded dense residual graph on ``device``.

    rows 0..n_rows-1 are live U vertices (original ids in ``members``);
    cols are the compacted V vertices with residual degree >= 2.  The
    biadjacency is built on the device: zeros, then ones scattered at the
    residual edges' linear ids (``_residual_edges``, 8 bytes an edge
    uploaded), so no host array of the padded shape is ever made.
    Alongside it the graph carries what the sweep loop needs: the initial
    residual V-degree vector (``dv0``), the static per-row wedge counts
    (host ``w_np`` for findHi) and the HUC recount bound ``c_rcnt``.  On
    the sparse backends it also carries the staircase extents, computed on
    the device from the built matrix: ``row_ext`` per row and ``kmax``
    per ``bi``-row tile (None on the dense backends, which never read
    them).

    With a ``plan`` (``repro_torch.api.ExecutionPlan``) the padded shape
    is recorded through ``plan.quantize_dim("dgm_rows" / "dgm_cols")``,
    the reference's shape hook, and left as built.  With ``stats`` its
    two uploads (the edge ids and ``dv0``) count in ``stats.trace``, and
    the matrix's bytes in ``stats.trace.built_bytes``.
    """

    def __init__(self, g: BipartiteGraph, members: np.ndarray,
                 cfg: ReceiptConfig, *, device, plan=None, stats=None):
        bi, bj, bk = cfg.kernel_blocks
        sparse = kops.resolve_backend(cfg.backend, device) in \
            kops.SPARSE_BACKENDS
        if sparse and bi != bj:
            raise ValueError("sparse backends require square row tiles "
                             f"(bi == bj), got kernel_blocks "
                             f"{cfg.kernel_blocks!r}")
        eu, ev, n_v, dvk = _residual_edges(g, members)

        self.members = np.asarray(members)
        self.n_rows = len(members)
        self.n_cols = max(n_v, 1)
        self.rows_pad = bucket(self.n_rows, max(bi, bj))
        self.cols_pad = bucket(self.n_cols, bk)
        if plan is not None:
            self.rows_pad = plan.quantize_dim("dgm_rows", self.rows_pad)
            self.cols_pad = plan.quantize_dim("dgm_cols", self.cols_pad)

        self.a = torch.zeros((self.rows_pad, self.cols_pad),
                             dtype=cfg.dtype, device=device)
        self.a.view(-1).index_fill_(
            0, upload(stats, eu * self.cols_pad + ev, device), 1)
        if stats is not None:
            stats.trace.built_bytes += self.a.numel() * self.a.element_size()
        self.ids = torch.arange(self.rows_pad, dtype=torch.int32,
                                device=device)
        # residual V degrees at construction (everything alive)
        dv_pad = np.zeros(self.cols_pad, np.float32)
        dv_pad[: len(dvk)] = dvk
        self.dv0 = upload(stats, dv_pad, device)
        # static per-row wedge counts in this residual graph (range proxy);
        # integer sums, exact in float64 in any order
        self.w_np = np.bincount(eu, weights=(dvk[ev] - 1).astype(np.float64),
                                minlength=self.rows_pad)
        self.total_wedges = float(self.w_np.sum())
        # Chiba-Nishizeki recount bound of this residual graph (HUC C_rcnt)
        du = np.bincount(eu, minlength=self.rows_pad)
        self.c_rcnt = float(np.minimum(du[eu], dvk[ev]).sum())
        if sparse:
            self.row_ext = ksparse.row_extents_device(self.a, bk)
            self.kmax = ksparse.tile_extents(self.row_ext, bi)
        else:
            self.row_ext = self.kmax = None


# ---------------------------------------------------------------------- #
# host-driven sweep (the device_loop=False engine)
# ---------------------------------------------------------------------- #
def host_sweep(dg, cfg: ReceiptConfig, stats: RunStats,
               support, alive, hi: float, lo: float, backend, blocks,
               *, allow_huc: bool = True):
    """One blocking host-driven sweep: select, decide, dispatch, fetch.

    Returns (support, alive, info) where info is None when nothing was
    peelable, else a dict with keys ``peel_np`` (host peel mask),
    ``n_peel`` and ``c_peel``.  The per-row wedge cost is recomputed from
    the residual degrees (the reference's ``sweep_info``).
    """
    sparse = backend in kops.SPARSE_BACKENDS
    peel = select_peel(support, alive, hi)
    dv = residual_dv(dg.a, alive)
    wcur = residual_wedges(dg.a, dv)
    c_peel_t = torch.where(peel, wcur, 0.0).sum()
    n_peel, c_peel, n_alive = fetch(stats, peel.sum(), c_peel_t, alive.sum())
    n_peel, c_peel = int(n_peel), float(c_peel)
    if n_peel == 0:
        return support, alive, None
    stats.rho_cd += 1
    lo_t = _scalar(lo, support)

    if int(n_alive) - n_peel == 0:
        # terminal-sweep elision: no survivor to update
        alive = alive & ~peel
        stats.elided_sweeps += 1
    elif allow_huc and cfg.use_huc and c_peel > dg.c_rcnt:
        # HUC: recount survivors instead of propagating peel updates
        alive = alive & ~peel
        support = support_all(dg.a, alive, dg.ids,
                              dg.kmax if sparse else None,
                              backend=backend, blocks=blocks, stats=stats)
        support = torch.where(alive, torch.maximum(support, lo_t), _INF)
        stats.huc_recounts += 1
        stats.wedges_cd += int(dg.c_rcnt)
    else:
        delta = peel_delta(dg.a, peel, n_peel, dg.ids, dg.row_ext, dg.kmax,
                           backend=backend, blocks=blocks, stats=stats)
        support, alive = apply_delta(support, alive, peel, delta, lo_t)
        support = torch.where(alive, support, _INF)
        stats.wedges_cd += int(c_peel)

    peel_np = fetch(stats, peel)[0].astype(bool)
    return support, alive, dict(peel_np=peel_np, n_peel=n_peel, c_peel=c_peel)
