"""The peel core, vertex axis (port of ``repro.core.engine.peel_loop``).

One sweep engine drives the peel schedules of this slice:

* **CD range-peel** (Alg. 3): peel everything with support < ``hi`` until
  the range drains; support updates cap at ``lo`` = theta(i).
  ``device_peel_loop(minmode=False)`` — used by `engine/cd.py`.
* **min-peel** (ParB schedule): each sweep peels the current
  minimum-support set.  ``device_peel_loop(minmode=True)``.
* **FD level-peel** (Alg. 4): peel the entire current-minimum support
  level per sweep, batched over a stack of independent induced subgraphs.
  ``batched_level_loop`` — used by `engine/fd.py`.

The reference runs these loops as ``lax.while_loop``s with ``lax.cond``
branches; here they are Python loops over device tensors.  Each loop
condition is read on the host once per sweep, and the HUC peel-vs-recount
choice once more per non-terminal sweep.  Every such blocking transfer goes
through ``fetch`` and counts in ``RunStats.host_round_trips`` (the port's
own number, not the reference's).

Because the peel-set size is read anyway, the CD gather is sized to it
(``bucket(n_peel, bj)``): the reference's fixed peel buffer, its overflow
flag and the host replay of an overflowed sweep never arise here, and
``RunStats.overflow_fallbacks`` stays 0.

Support updates go through the kernel entry points of
``repro_torch.kernels.ops`` — kernel 1 (``butterfly_update``) for the
single-graph loop, kernel 2 (``butterfly_update_batched``) and kernel 3
(``b2_stack``) for the batched loop.

Exactness: supports, wedge counts and the f32 wedge/covered accumulators
are integers below 2^24 and exact in float32 (DESIGN.md section 8), as in
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ...kernels import ops as kops
from ..graph import BipartiteGraph

__all__ = [
    "ReceiptConfig",
    "RunStats",
    "bucket",
    "fetch",
    "DeviceGraph",
    "device_peel_loop",
    "batched_level_loop",
    "host_sweep",
    "support_all",
    "support_delta",
    "residual_dv",
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


# ---------------------------------------------------------------------- #
# device primitives
# ---------------------------------------------------------------------- #
def support_all(a, alive, ids, *, backend, blocks):
    """HUC recount / initial count: support of every row w.r.t. alive rows."""
    return kops.butterfly_update(a, a, alive.to(a.dtype), ids, ids,
                                 backend=backend, blocks=blocks)


def support_delta(a, a_peel, valid, ids, ids_peel, *, backend, blocks):
    """CD peel update: delta[u'] = sum_{u in S} C(W[u, u'], 2)."""
    return kops.butterfly_update(a, a_peel, valid.to(a.dtype), ids, ids_peel,
                                 backend=backend, blocks=blocks)


def residual_dv(a, alive):
    """Residual V degrees of the alive rows."""
    return a.T @ alive.to(a.dtype)


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


# ---------------------------------------------------------------------- #
# one sweep of the single-graph loop
# ---------------------------------------------------------------------- #
def _sweep_once(a, ids, c_rcnt, hi_cur, cap, support, alive, dv, theta,
                peeled, wedges, covered, *, backend, blocks, use_huc,
                minmode, stats):
    """One peel sweep of ``device_peel_loop`` (reference ``_sweep_once``,
    vertex axis): peel selection at ``hi_cur``, terminal-sweep elision,
    the gather sized to the peel set, the HUC peel-vs-recount choice and
    the incremental residual-degree / wedge-counter updates.

    ``c_rcnt`` is the HUC recount bound as a (host float, f32 tensor)
    pair.  Returns None when the peel set is empty (the loop's exit test,
    read in the same transfer as the sizes), else (support, alive, dv,
    theta, peeled, wedges, covered, recounted, elided).
    """
    peel = select_peel(support, alive, hi_cur)
    n_peel, n_alive = (int(x) for x in fetch(stats, peel.sum(), alive.sum()))
    if n_peel == 0:
        return None
    theta2 = record_theta(theta, peel, cap) if minmode else theta
    if n_peel == n_alive:
        # terminal-sweep elision: a sweep that peels EVERY survivor needs
        # no update kernel; the full peel set's column sums are dv itself
        c_peel = peel_cost(dv, dv)
        return (support, alive & ~peel, torch.zeros_like(dv), theta2,
                peeled | peel, wedges, covered + c_peel, False, True)

    width = min(bucket(n_peel, blocks[1]), a.shape[0])
    rows, valid, a_peel = _gather_peel(a, peel, n_peel, width)
    # incremental residual degrees: peeled rows' column sums
    colsum = valid.to(_F32) @ a_peel.to(_F32)
    c_peel = peel_cost(colsum, dv)
    c_rcnt_host, c_rcnt_dev = c_rcnt
    use_rec = use_huc and float(fetch(stats, c_peel)[0]) > c_rcnt_host
    if use_rec:
        alive2 = alive & ~peel
        s2 = support_all(a, alive2, ids, backend=backend, blocks=blocks)
        support2 = torch.where(alive2, torch.maximum(s2, cap), _INF)
        wedges = wedges + c_rcnt_dev
    else:
        delta = support_delta(a, a_peel, valid, ids, rows, backend=backend,
                              blocks=blocks)
        s2, alive2 = apply_delta(support, alive, peel, delta, cap)
        support2 = torch.where(alive2, s2, _INF)
        wedges = wedges + c_peel
    return (support2, alive2, dv - colsum, theta2, peeled | peel, wedges,
            covered + c_peel, use_rec, False)


# ---------------------------------------------------------------------- #
# single-graph sweep loop (CD range-peel / min-peel)
# ---------------------------------------------------------------------- #
def device_peel_loop(a, ids, support, alive, dv, theta, hi, lo, c_rcnt,
                     sweeps0=0, *, backend, blocks, use_huc, max_sweeps,
                     minmode, stats=None):
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
    callers re-enter on a cap-exit with peelable rows left.

    Returns (support, alive, dv, theta, peeled, rho, wedges, hucs, elided,
    covered, sweeps, overflow) like the reference; ``wedges`` and
    ``covered`` are f32 device scalars (exact below 2^24), the counts are
    Python ints and ``overflow`` is always False.
    """
    dev = support.device
    hi = _f32_scalar(hi, dev)
    lo = _f32_scalar(lo, dev)
    c_rcnt_host = float(np.float32(c_rcnt))
    c_rcnt = (c_rcnt_host, _f32_scalar(c_rcnt_host, dev))
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
        out = _sweep_once(
            a, ids, c_rcnt, hi_cur, cap, support, alive, dv, theta, peeled,
            wedges, covered, backend=backend, blocks=blocks,
            use_huc=(use_huc and not minmode), minmode=minmode, stats=stats)
        if out is None:
            break
        (support, alive, dv, theta, peeled, wedges, covered, rec,
         eli) = out
        rho += 1
        hucs += int(rec)
        elided += int(eli)
        sweeps += 1
    return (support, alive, dv, theta, peeled, rho, wedges, hucs, elided,
            covered, sweeps, False)


# ---------------------------------------------------------------------- #
# batched level-peel loop (FD: a stack of independent subsets)
# ---------------------------------------------------------------------- #
def batched_level_loop(a, support, alive, dv, lo, *, backend, blocks,
                       peel_width, max_sweeps, update_mode="kernel",
                       stats=None):
    """Peel a stack of G independent subsets by whole support levels.

    Each sweep peels, in EVERY still-live group, the entire
    current-minimum support level (``level_threshold`` with the group's
    theta lower bound ``lo[g]``).

    a:       (G, M, C)  stacked induced biadjacencies (0/1)
    support: (G, M)     FD-initialized supports (+inf on padding rows)
    alive:   (G, M)     bool (False on padding rows)
    dv:      (G, C)     residual V-degrees of each induced subgraph
    lo:      (G,)       per-subset theta lower bounds (CD range floors)

    The peel level is gathered into a fixed (G, ``peel_width``, C) buffer.
    A sweep where ANY group's level exceeds the buffer uses the mask form
    (B = A, s = peel mask) instead: same output, no gather.  The loop test
    and the largest level are read in one transfer per sweep.

    ``update_mode``: ``"kernel"`` streams every sweep through kernel 2;
    ``"b2"`` computes the (G, M, M) shared-butterfly stack ONCE with
    kernel 3 (whose CUDA version masks ragged edges, so unlike the
    reference no block-alignment test routes around it) and reduces its
    gathered rows per sweep.  Both give bit-identical deltas.

    Returns (support, alive, dv, theta, rho, wedges, max_level, sweeps)
    as the reference does: ``theta`` (G, M), per-group ``rho`` (int32),
    ``wedges`` (f32) and ``max_level`` (int32) tensors, ``sweeps`` int.
    """
    g_n, mm, _cc = a.shape
    dev = a.device
    lo = _f32_scalar(lo, dev)
    ids = torch.arange(mm, dtype=torch.int32, device=dev).expand(
        g_n, mm).contiguous()
    if update_mode == "b2":
        b2 = kops.b2_stack(a.to(_F32), backend=backend, blocks=blocks)
    elif update_mode != "kernel":
        raise ValueError(f"unknown update_mode {update_mode!r}")

    def full_mask_update(peel):
        """Full-width update: B = A, s = peel mask (no gather)."""
        if update_mode == "b2":
            delta = torch.einsum("gm,gmn->gn", peel.to(_F32), b2)
        else:
            delta = kops.butterfly_update_batched(
                a, a, peel.to(a.dtype), ids, ids, backend=backend,
                blocks=blocks)
        colsum = torch.einsum("gm,gmc->gc", peel.to(_F32), a.to(_F32))
        return delta, colsum

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
            delta = torch.einsum("gw,gwm->gm", valid.to(_F32), b2_rows)
        else:
            delta = kops.butterfly_update_batched(
                a, a_peel, valid, ids, rows, backend=backend, blocks=blocks)
        colsum = torch.einsum("gw,gwc->gc", valid.to(_F32),
                              a_peel.to(_F32))
        return delta, colsum

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
    (host ``w_np`` for findHi) and the HUC recount bound ``c_rcnt``.  The
    reference also carries staircase extents (``row_ext``/``kmax``) for
    its sparse backends; they return here with the sparse backend.
    """

    def __init__(self, g: BipartiteGraph, members: np.ndarray,
                 cfg: ReceiptConfig, *, device):
        bi, bj, bk = cfg.kernel_blocks
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
    two dense contractions (the reference's ``sweep_info``).
    """
    peel = select_peel(support, alive, hi)
    dv = residual_dv(dg.a, alive)
    wcur = dg.a @ torch.clamp(dv - 1.0, min=0.0)
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
        support = support_all(dg.a, alive, dg.ids, backend=backend,
                              blocks=blocks)
        support = torch.where(alive, torch.maximum(support, lo_t), _INF)
        stats.huc_recounts += 1
        stats.wedges_cd += int(dg.c_rcnt)
    else:
        width = min(bucket(n_peel, blocks[1]), dg.rows_pad)
        rows, valid, a_peel = _gather_peel(dg.a, peel, n_peel, width)
        delta = support_delta(dg.a, a_peel, valid, dg.ids, rows,
                              backend=backend, blocks=blocks)
        support, alive = apply_delta(support, alive, peel, delta, lo_t)
        support = torch.where(alive, support, _INF)
        stats.wedges_cd += int(c_peel)

    peel_np = fetch(stats, peel)[0].astype(bool)
    return support, alive, dict(peel_np=peel_np, n_peel=n_peel, c_peel=c_peel)
