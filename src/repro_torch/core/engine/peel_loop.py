"""The peel core, vertex axis (port of ``repro.core.engine.peel_loop``).

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

Exactness: supports, wedge counts and the f32 wedge/covered accumulators
are integers below 2^24 and exact in float32 (DESIGN.md section 8), as in
the reference.  PyTorch may run a float32 matrix product on the tensor
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
from ..graph import BipartiteGraph

__all__ = [
    "ReceiptConfig",
    "RunStats",
    "bucket",
    "fetch",
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
]

_INF = float("inf")
_F32 = torch.float32


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
    count it in ``stats.host_round_trips``."""
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


def _f32_scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=device)


def _masked_rows_sum(m, mask):
    """``mask @ m`` over the row axis (second to last) as a masked sum:
    full f32 for entries past 2048 (the B2 rows), whatever the global
    TF32 setting."""
    return (m * mask.to(m.dtype).unsqueeze(-1)).sum(dim=-2)


# ---------------------------------------------------------------------- #
# device primitives
# ---------------------------------------------------------------------- #
def support_all(a, alive, ids, kmax, *, backend, blocks):
    """HUC recount / initial count: support of every row w.r.t. alive rows
    (``kmax`` the row-tile extents on the sparse backends, else None)."""
    return kops.butterfly_update(a, a, alive.to(a.dtype), ids, ids,
                                 backend=backend, blocks=blocks,
                                 kmax_a=kmax, kmax_b=kmax, body="count")


def support_delta(a, a_peel, valid, ids, ids_peel, kmax_a, kmax_b, *,
                  backend, blocks):
    """CD peel update: delta[u'] = sum_{u in S} C(W[u, u'], 2)."""
    return kops.butterfly_update(a, a_peel, valid.to(a.dtype), ids, ids_peel,
                                 backend=backend, blocks=blocks,
                                 kmax_a=kmax_a, kmax_b=kmax_b)


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
    """Min-peel threshold: cap = max(min alive support, lo), hi = cap + 1.

    Dead batch members yield cap = inf, which makes every downstream piece
    a no-op.
    """
    mn = torch.where(alive, support, _INF).amin(dim=-1)
    cap = torch.maximum(mn, _f32_scalar(lo, support.device))
    return cap + 1.0, cap


def select_peel(support, alive, hi):
    """Peel set of one sweep: alive rows with support below ``hi``."""
    hi = _f32_scalar(hi, support.device)
    return alive & (support < hi.unsqueeze(-1))


def apply_delta(support, alive, peel, delta, lo):
    """Alg. 2 update with the Alg. 3 range cap: cap at theta(i) = lo."""
    alive_after = alive & ~peel
    cap = _f32_scalar(lo, support.device).unsqueeze(-1)
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


def _gather_peel(a, peel, n_peel: int, width: int):
    """The peel rows of ``a`` gathered into a (width, n_v) matrix, in row
    order (a stable sort puts them first), padding rows zeroed; returns
    (rows int32, valid bool, a_peel)."""
    order = torch.argsort((~peel).to(torch.int8), stable=True)[:width]
    valid = torch.arange(width, device=a.device) < n_peel
    rows = torch.where(valid, order, 0).to(torch.int32)
    a_peel = a[rows] * valid[:, None].to(a.dtype)
    return rows, valid, a_peel


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
    terminal-sweep elision, the gather sized to the peel set, the HUC
    peel-vs-recount choice and the incremental residual-degree / wedge
    counter updates.  The caller has selected ``peel`` and read its sizes
    (``_peel_sizes``), and records theta / the peeled set itself.
    ``widths`` (a list, or None) gets the row count of each gather.

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

    width = min(bucket(n_peel, blocks[1]), a.shape[0])
    if widths is not None:
        widths.append(width)
    rows, valid, a_peel = _gather_peel(a, peel, n_peel, width)
    # incremental residual degrees: peeled rows' column sums
    colsum = a_peel.sum(dim=0)
    c_peel = peel_cost(colsum, dv)
    use_rec = use_huc and bool(fetch(stats, c_peel > c_rcnt)[0])
    if use_rec:
        alive2 = alive & ~peel
        s2 = support_all(a, alive2, ids, kmax if sparse else None,
                         backend=backend, blocks=blocks)
        support2 = torch.where(alive2, torch.maximum(s2, cap), _INF)
        wedges = wedges + c_rcnt
    else:
        kb = (ksparse.gathered_tile_extents(row_ext, rows, valid, blocks[1])
              if sparse else None)
        delta = support_delta(a, a_peel, valid, ids, rows,
                              kmax if sparse else None, kb,
                              backend=backend, blocks=blocks)
        s2, alive2 = apply_delta(support, alive, peel, delta, cap)
        support2 = torch.where(alive2, s2, _INF)
        wedges = wedges + c_peel
    return (support2, alive2, dv - colsum, wedges, covered + c_peel, use_rec,
            False)


# ---------------------------------------------------------------------- #
# single-graph sweep loop (CD range-peel / min-peel)
# ---------------------------------------------------------------------- #
def device_peel_loop(a, ids, support, alive, dv, theta, hi, lo, c_rcnt,
                     sweeps0=0, *, backend, blocks, use_huc, max_sweeps,
                     minmode, row_ext=None, kmax=None, stats=None,
                     widths=None):
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
    callers re-enter on a cap-exit with peelable rows left.  ``row_ext`` /
    ``kmax`` are ``a``'s staircase extents, required on the sparse
    backends.  ``widths`` (a list, or None) gets each gather's row count.

    Returns (support, alive, dv, theta, peeled, rho, wedges, hucs, elided,
    covered, sweeps, overflow) like the reference; ``wedges`` and
    ``covered`` are f32 device scalars (exact below 2^24), the counts are
    Python ints and ``overflow`` is always False.
    """
    dev = support.device
    hi = _f32_scalar(hi, dev)
    lo = _f32_scalar(lo, dev)
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
    them.  ``_receipt_cd_graph`` re-enters with the returned state after a
    ``max_iters`` cap-exit, resetting only ``iters``.
    """
    dev = support.device
    rows_pad = dg.rows_pad
    return dict(
        a=dg.a, dv=dg.dv0, row_ext=dg.row_ext, kmax=dg.kmax,
        c_rcnt=_f32_scalar(dg.c_rcnt, dev), dgm=0,
        support=support, alive=alive,
        subset_of=torch.full((rows_pad,), -1, dtype=torch.int32, device=dev),
        init_sup=torch.zeros(rows_pad, dtype=_F32, device=dev),
        bounds=torch.zeros(p_total + 1, dtype=_F32, device=dev),
        rho_sub=[], i=-1,
        hi=_f32_scalar(-_INF, dev), lo=_f32_scalar(0.0, dev),
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
    Rows keep their places, so supports and subset stamps are untouched."""
    a0 = st["a"] * st["alive"][:, None].to(st["a"].dtype)
    live_col = st["dv"] >= 2.0
    perm = torch.argsort((~live_col).to(torch.int8), stable=True)
    a2 = a0[:, perm] * live_col[perm][None, :].to(a0.dtype)
    dv = torch.where(live_col, st["dv"], 0.0)[perm]
    if sparse:
        row_ext, kmax = kops.tighten_extents_device(
            a2, live_col.sum(), block_rows=blocks[0], block_k=blocks[2])
    else:
        row_ext, kmax = st["row_ext"], st["kmax"]
    du = a2.sum(dim=1)
    c_rcnt = (a2 * torch.minimum(du[:, None], dv[None, :])).sum()
    return dict(st, a=a2, dv=dv, row_ext=row_ext, kmax=kmax, c_rcnt=c_rcnt)


def _graph_boundary(st: dict, done: bool, *, blocks, sparse, use_dgm,
                    p_total) -> dict:
    """Close subset ``i`` (none on the first entry, i = -1) and, unless no
    row is alive, open subset ``i + 1``: on-device DGM, the ``init_sup``
    snapshot, fresh residual wedge counts ``w = a @ max(dv - 1, 0)`` and
    the next ``hi`` from ``find_hi_device``.  No host read."""
    i = st["i"]
    st = dict(st, iters=st["iters"] + 1)
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
        return dict(st, done=True)
    if use_dgm:
        st = _compact_residual(st, blocks, sparse)
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
    return dict(
        st, i=i2, tgt=tgt,
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
    st = dict(state)
    while not st["done"] and st["iters"] < max_iters:
        peel, n_peel, n_alive = _peel_sizes(st["support"], st["alive"],
                                            st["hi"], stats)
        if n_peel == 0:
            st = _graph_boundary(st, n_alive == 0, blocks=blocks,
                                 sparse=sparse, use_dgm=use_dgm,
                                 p_total=p_total)
            continue
        support, alive, dv, wedges, covered, rec, eli = _sweep_once(
            st["a"], ids, st["row_ext"], st["kmax"], st["c_rcnt"], st["lo"],
            st["support"], st["alive"], st["dv"], st["wedges"],
            st["covered"], peel, n_peel, n_alive, backend=backend,
            blocks=blocks, use_huc=use_huc, stats=stats, widths=widths)
        st = dict(
            st, support=support, alive=alive, dv=dv, wedges=wedges,
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
                       row_ext=None, stats=None):
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
    per sweep.  Both give bit-identical deltas.

    Returns (support, alive, dv, theta, rho, wedges, max_level, sweeps)
    as the reference does: ``theta`` (G, M), per-group ``rho`` (int32),
    ``wedges`` (f32) and ``max_level`` (int32) tensors, ``sweeps`` int.
    """
    g_n, mm, _cc = a.shape
    dev = a.device
    sparse = backend in kops.SPARSE_BACKENDS
    lo = _f32_scalar(lo, dev)
    ids = torch.arange(mm, dtype=torch.int32, device=dev).expand(
        g_n, mm).contiguous()
    if sparse:
        kmax_a = ksparse.tile_extents(row_ext, blocks[0])
        kmax_mask = ksparse.tile_extents(row_ext, blocks[1])
    else:
        kmax_a = kmax_mask = None
    if update_mode == "b2":
        b2 = kops.b2_stack(a.to(_F32), backend=backend, blocks=blocks)
    elif update_mode != "kernel":
        raise ValueError(f"unknown update_mode {update_mode!r}")

    def full_mask_update(peel):
        """Full-width update: B = A, s = peel mask (no gather)."""
        if update_mode == "b2":
            delta = _masked_rows_sum(b2, peel)
        else:
            delta = kops.butterfly_update_batched(
                a, a, peel.to(a.dtype), ids, ids, backend=backend,
                blocks=blocks, kmax_a=kmax_a, kmax_b=kmax_mask)
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
            delta = kops.butterfly_update_batched(
                a, a_peel, valid, ids, rows, backend=backend, blocks=blocks,
                kmax_a=kmax_a, kmax_b=kb)
        return delta, a_peel.to(_F32).sum(dim=1)

    theta = torch.zeros((g_n, mm), dtype=_F32, device=dev)
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


# ---------------------------------------------------------------------- #
# device-graph container (bucketed, compacted view of the residual graph)
# ---------------------------------------------------------------------- #
class DeviceGraph:
    """Bucket-padded dense residual graph on ``device``.

    rows 0..n_rows-1 are live U vertices (original ids in ``members``);
    cols are the compacted V vertices with residual degree >= 2.  Alongside
    the biadjacency it carries what the sweep loop needs: the initial
    residual V-degree vector (``dv0``), the static per-row wedge counts
    (host ``w_np`` for findHi) and the HUC recount bound ``c_rcnt``.  On
    the sparse backends it also carries the staircase extents, computed on
    the device from the uploaded matrix: ``row_ext`` per row and ``kmax``
    per ``bi``-row tile (None on the dense backends, which never read
    them).

    With a ``plan`` (``repro_torch.api.ExecutionPlan``) the padded shape
    is recorded through ``plan.quantize_dim("dgm_rows" / "dgm_cols")``,
    the reference's shape hook, and left as built.
    """

    def __init__(self, g: BipartiteGraph, members: np.ndarray,
                 cfg: ReceiptConfig, *, device, plan=None):
        bi, bj, bk = cfg.kernel_blocks
        sparse = kops.resolve_backend(cfg.backend, device) in \
            kops.SPARSE_BACKENDS
        if sparse and bi != bj:
            raise ValueError("sparse backends require square row tiles "
                             f"(bi == bj), got kernel_blocks "
                             f"{cfg.kernel_blocks!r}")
        # induce on the live rows, dropping V columns that cannot form a
        # wedge (residual degree < 2) — the DGM column compaction
        sub, _ = g.induced_on_u(members, min_degree_v=2)
        dvk = sub.degrees_v()
        eu, ev = sub.edges_u, sub.edges_v

        self.members = np.asarray(members)
        self.n_rows = len(members)
        self.n_cols = max(int(sub.n_v), 1)
        self.rows_pad = bucket(self.n_rows, max(bi, bj))
        self.cols_pad = bucket(self.n_cols, bk)
        if plan is not None:
            self.rows_pad = plan.quantize_dim("dgm_rows", self.rows_pad)
            self.cols_pad = plan.quantize_dim("dgm_cols", self.cols_pad)

        a = np.zeros((self.rows_pad, self.cols_pad), np.float32)
        a[eu, ev] = 1.0
        self.a = torch.from_numpy(a).to(device=device, dtype=cfg.dtype)
        self.ids = torch.arange(self.rows_pad, dtype=torch.int32,
                                device=device)
        # residual V degrees at construction (everything alive)
        dv_pad = np.zeros(self.cols_pad, np.float32)
        dv_pad[: len(dvk)] = dvk
        self.dv0 = torch.from_numpy(dv_pad).to(device)
        # static per-row wedge counts in this residual graph (range proxy)
        w = np.zeros(self.rows_pad, np.float64)
        np.add.at(w, eu, (dvk[ev] - 1).astype(np.float64))
        self.w_np = w
        self.total_wedges = float(w.sum())
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
    lo_t = _f32_scalar(lo, support.device)

    if int(n_alive) - n_peel == 0:
        # terminal-sweep elision: no survivor to update
        alive = alive & ~peel
        stats.elided_sweeps += 1
    elif allow_huc and cfg.use_huc and c_peel > dg.c_rcnt:
        # HUC: recount survivors instead of propagating peel updates
        alive = alive & ~peel
        support = support_all(dg.a, alive, dg.ids,
                              dg.kmax if sparse else None,
                              backend=backend, blocks=blocks)
        support = torch.where(alive, torch.maximum(support, lo_t), _INF)
        stats.huc_recounts += 1
        stats.wedges_cd += int(dg.c_rcnt)
    else:
        width = min(bucket(n_peel, blocks[1]), dg.rows_pad)
        rows, valid, a_peel = _gather_peel(dg.a, peel, n_peel, width)
        kb = (ksparse.gathered_tile_extents(dg.row_ext, rows, valid,
                                            blocks[1])
              if sparse else None)
        delta = support_delta(dg.a, a_peel, valid, dg.ids, rows,
                              dg.kmax if sparse else None, kb,
                              backend=backend, blocks=blocks)
        support, alive = apply_delta(support, alive, peel, delta, lo_t)
        support = torch.where(alive, support, _INF)
        stats.wedges_cd += int(c_peel)

    peel_np = fetch(stats, peel)[0].astype(bool)
    return support, alive, dict(peel_np=peel_np, n_peel=n_peel, c_peel=c_peel)
