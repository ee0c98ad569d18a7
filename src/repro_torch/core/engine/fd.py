"""FD — fine-grained decomposition (the paper's Alg. 4), batched level peel.

Port of ``repro.core.engine.fd`` (``fd_mode="level"``).  Each CD subset's
induced subgraph is peeled independently.  Subsets are grouped into
equal-padded-shape stacks (`core/scheduler.py`) and each stack is peeled by
the peel core's batched level-peel loop
(`engine/peel_loop.batched_level_loop`): every sweep removes the whole
current-minimum support level of every still-live subset in the stack.

* **iterated host pre-peel** (``pre_peel_tasks``): up to
  ``cfg.fd_prepeel_levels`` peel levels of every subset are resolved from
  the host support snapshot; the device stacks hold the SURVIVORS, and the
  last hoisted level's delta reaches them through one kernel-2 call whose
  gathered ids are offset by ``mm`` so the self-mask never fires;
* **double-buffered group dispatch** (``cfg.fd_overlap``): a group's
  uploads and first-level delta are launched (asynchronously) before the
  host builds the NEXT group's stacks, and the group is drained — level
  loop, one final fetch — after that build;
* ``RunStats.rho_fd`` counts level sweeps, ``RunStats.wedges_fd`` the
  dynamically traversed wedges.

``fd_update_mode``: ``"auto"`` precomputes the (G, M, M) B2 stack (kernel
3) when ``G*M*M <= fd_b2_cells`` and streams through kernel 2 otherwise;
``"b2"`` / ``"kernel"`` pin either side; both give bit-identical deltas.
On the sparse backends kernel 5 takes kernel 2's place, fed per-group
staircase extents that the launcher derives on the card from the uploaded
stacks (equal to the reference's host ``batched_row_extents``).

``fd_mode="b2"`` / ``"matvec"`` are the legacy sequential engines (the
paper's one-vertex-per-step peel, kept as comparators): every member of a
shape group is peeled one vertex per step, batched over the group as the
reference's ``vmap``, on the device with no read per step.  ``"b2"`` takes
its B2 rows from the kernel-3 stack (which masks ragged edges itself, so
unlike the reference no alignment test sends the stack to a plain
version), ``"matvec"`` recomputes one B2 row per step.

``receipt_fd(mesh=...)`` runs the level pipeline over a
``repro_torch.launch.mesh.DeviceMesh`` (``_run_level_groups_mesh``): each
shape group's stacks are LPT-laid over the mesh's shards
(``core/distributed.py``) and each shard peels its slice on its device.

With a ``plan`` (``repro_torch.api.ExecutionPlan``) the level stacks take
the reference's two hooks: every stack dimension (``fd_rows``,
``fd_cols``, ``fd_l1``, ``fd_groups``) is recorded through
``plan.quantize_dim`` and left as built (no jit cache to keep warm), and
the gather width of a stack shape is the one an earlier run measured
(``plan.fd_width_hint``; a level that outgrows it takes the mask-form
update).  Each drained group records its
largest level back (``plan.note_fd_level``).  The plan's
``padded_bytes`` is a budget the level pipeline keeps (``_pipeline``:
a shape group that would not fit launches in parts).  Theta is the same
either way.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ...api.errors import KernelBackendError
from ...api.faults import fault_point
from ...kernels import butterfly as kbfly
from ...kernels import butterfly_sparse as ksparse
from ...kernels import ops as kops
from ...utils.spans import span
from ..graph import BipartiteGraph, pad_to_multiple
from ..scheduler import lpt_shard_plan, pack_by_shape
from .peel_loop import (
    _INF,
    SUPPORT_DTYPE,
    ReceiptConfig,
    RunStats,
    batched_level_loop,
    bucket,
    fetch,
    note_wide,
    upload,
)

__all__ = ["receipt_fd", "build_fd_tasks", "pre_peel_tasks",
           "build_level_stack", "fd_state_bytes", "fd_update_bytes"]

# device-memory model of the level stacks (``api/plan.py`` counts a plan's
# FD bytes with it, and ``_pipeline`` keeps each launch within a plan's):
# f32 cells of the 0/1 stacks, f64 B2 entries, and the per-row and
# per-column bytes of the sweep state (supports, masks, theta, ids,
# extents, column sums and the like).  WIDE_ROW_VECTORS of a row's state
# are float64 (DESIGN.md section 8): the supports, theta, a sweep's delta
# and its capped successor, 4 bytes each more than the float32 model's
# 64 a row; the column state (residual degrees, column sums) stays f32.
_F32_BYTES = 4
_F64_BYTES = 8
B2_BYTES = _F64_BYTES
WIDE_ROW_VECTORS = 4
COL_STATE_BYTES = 64
ROW_STATE_BYTES = COL_STATE_BYTES + WIDE_ROW_VECTORS * (_F64_BYTES
                                                        - _F32_BYTES)


def fd_state_bytes(n_slots: int, mm: int, cc: int) -> int:
    """What one launched FD shape group keeps on the card until it
    drains: the survivor stack and its per-row and per-column state."""
    return (_F32_BYTES * n_slots * mm * cc
            + ROW_STATE_BYTES * n_slots * mm + COL_STATE_BYTES * n_slots * cc)


def fd_update_bytes(n_up: int, mm: int, cc: int, w1: int,
                    b2_mode: bool) -> int:
    """What the level loop of ``n_up`` slots adds while it drains, with a
    peel set of ``w1`` gathered rows: in b2 mode the f64 B2 stack, then the
    largest of kernel 3's s8 copy (while the stack is built) and the
    sweep's temporaries: a gathered update's B2 rows (three row blocks
    live at once, as the caching allocator's history shows on the card)
    and its A rows twice, or, where the gather would take every row, the
    mask form's B2-sized product; in kernel mode a gather of up to every
    row and kernel 2's scratch.  At least the next group's first-level
    stack, which its launch uploads meanwhile."""
    if b2_mode:
        if w1 < mm:
            sweep = n_up * w1 * (B2_BYTES * 3 * mm + _F32_BYTES * 2 * cc)
        else:
            sweep = B2_BYTES * n_up * mm * mm
        update = (B2_BYTES * n_up * mm * mm
                  + max(n_up * kbfly.count_scratch_bytes(mm, cc), sweep))
    else:
        update = (_F32_BYTES * n_up * mm * cc
                  + kbfly.peel_scratch_bytes(mm, cc, n_up))
    return max(update, _F32_BYTES * n_up * w1 * cc
               + kbfly.peel_scratch_bytes(mm, cc, n_up))


def b2_update(n_g: int, mm: int, cfg: ReceiptConfig) -> bool:
    """Whether a stack of ``n_g`` groups of ``mm`` rows takes the B2
    update (``fd_update_mode``; ``"auto"``: its B2 stack fits
    ``fd_b2_cells``)."""
    return cfg.fd_update_mode == "b2" or (
        cfg.fd_update_mode == "auto" and n_g * mm * mm <= cfg.fd_b2_cells)


# ---------------------------------------------------------------------- #
# legacy sequential peels (fd_mode="b2" / "matvec"; the PR-1 comparators)
# ---------------------------------------------------------------------- #
def _sequential_peel(sup0, n_members, lo, b2_row):
    """Exact sequential bottom-up peel of a (G, M) stack, one vertex of
    every group per step (the reference's ``fori_loop`` under ``vmap``).

    ``sup0`` (G, M) FD-initialized supports (+inf on padding), ``n_members``
    (G,) int, ``lo`` (G,) theta lower bounds; ``b2_row(u)`` returns the
    (G, M) rows of pairwise shared butterflies of the vertices ``u`` (G,)
    with a zero at ``u``.  Step t peels, in each group with t < n_members,
    the alive vertex of least support (the first on ties).  Returns theta
    (G, M).
    """
    g_n, mm = sup0.shape
    dev = sup0.device
    cols = torch.arange(mm, device=dev)
    sup = sup0
    alive = cols[None, :] < n_members[:, None]
    theta = torch.zeros_like(sup0)
    for t in range(mm):
        masked = torch.where(alive, sup, _INF)
        u = torch.argmin(masked, dim=1)                          # (G,)
        th = torch.maximum(masked.gather(1, u[:, None]), lo[:, None])
        at_u = (cols[None, :] == u[:, None]) & (t < n_members)[:, None]
        theta = torch.where(at_u, th, theta)
        new_sup = torch.maximum(sup - b2_row(u), th)
        sup = torch.where((t < n_members)[:, None] & alive, new_sup, sup)
        alive = alive & ~at_u
    return theta


def _fd_peel_b2(b2, sup0, n_members, lo):
    """Sequential peel of a group with precomputed B2 rows (B2 mode).

    b2: (G, M, M) pairwise shared butterflies (zero diagonal, zero on
    padding)."""
    return _sequential_peel(
        sup0, n_members, lo,
        lambda u: b2.gather(1, u[:, None, None].expand(-1, 1, b2.shape[2]))
        [:, 0])


def _fd_peel_matvec(a_sub, sup0, n_members, lo):
    """Sequential peel recomputing one B2 row per step (matvec mode):
    a_sub (G, M, C) induced biadjacencies; avoids the (G, M, M) stack."""
    cols = torch.arange(a_sub.shape[1], device=a_sub.device)

    def b2_row(u):
        a_u = a_sub.gather(1, u[:, None, None].expand(-1, 1, a_sub.shape[2]))
        w = torch.bmm(a_sub, a_u.transpose(1, 2))[:, :, 0]      # (G, M)
        w = w.to(SUPPORT_DTYPE)
        b2 = w * (w - 1.0) * 0.5
        return torch.where(cols[None, :] == u[:, None], 0.0, b2)

    return _sequential_peel(sup0, n_members, lo, b2_row)


# ---------------------------------------------------------------------- #
# task construction + scheduling
# ---------------------------------------------------------------------- #
def build_fd_tasks(g: BipartiteGraph, subset_id: np.ndarray,
                   bounds: np.ndarray, stats: RunStats) -> List[Dict]:
    """Induce each subset's subgraph (the paper's "only traverse its
    wedges" saving) and record per-subset size/wedge-bound stats (the
    span ``fd.tasks``)."""
    n_sub = int(subset_id.max()) + 1 if subset_id.size else 0
    tasks = []
    with span("fd.tasks", stats):
        for i in range(n_sub):
            members = np.where(subset_id == i)[0]
            stats.subset_sizes.append(len(members))
            if len(members) == 0:
                stats.subset_wedges_fd.append(0)
                continue
            sub, _ = g.induced_on_u(members)
            wsub = int(sub.wedge_counts_u().sum())
            stats.subset_wedges_fd.append(wsub)
            tasks.append(
                dict(
                    members=members,
                    sub=sub,
                    lo=float(bounds[i]),
                    wedges=wsub,
                )
            )
    return tasks


def _aligns(cfg: ReceiptConfig):
    """Row/col/first-level padding multiples: the kernel blocks (the plain
    versions share the kernels' padding)."""
    bi, bj, bk = cfg.kernel_blocks
    return max(bi, bj), bk, bj


def pre_peel_tasks(tasks: List[Dict], init_support: np.ndarray,
                   theta: np.ndarray, stats: RunStats,
                   levels: int = 1) -> List[Dict]:
    """Host-side pre-peel of up to ``levels`` support levels.

    A subset's first peel level is fully determined by the host support
    snapshot — cap = max(min support, lo), level = everyone at or below
    cap — so its theta (= cap) is assigned here, its wedge cost is
    accounted here, and the device stack is built from the survivors only.
    Levels 2, 3, ... are derived by the exact host butterfly delta (for
    survivor u and level set L, ``delta[u] = sum_{x in L} C(|N(u) & N(x)|,
    2)``), then supports floor at the level cap.  Theta is identical for
    every ``levels >= 1``.  The LAST hoisted level is handed to the device
    unchanged: ``l1``/``cap1``/``sup_surv`` describe it, and the launcher
    applies its delta through one kernel-2 call.

    Mutates ``theta`` / ``stats`` (rho_fd += 1 and the level's dynamic
    C_peel per hoisted level) and returns the survivor task list.
    """
    levels = max(int(levels), 1)
    out = []
    for t in tasks:
        mems, sub, lo = t["members"], t["sub"], t["lo"]
        sup = np.asarray(init_support[mems], np.float64).copy()
        n = len(mems)
        alive = np.ones(n, bool)
        # column degrees of the still-alive rows (wedge accounting)
        dv_cur = np.bincount(sub.edges_v, minlength=sub.n_v)
        a_host = None                   # dense rows, built lazily
        for lvl in range(levels):
            cap_l = (max(float(sup[alive].min()), lo) if alive.any()
                     else lo)
            l_mask = alive & (sup <= cap_l)
            theta[mems[l_mask]] = cap_l
            # dynamic wedge cost of this sweep: colsum_L . max(dv - 1, 0)
            peel_e = l_mask[sub.edges_u]
            colsum = np.bincount(sub.edges_v[peel_e], minlength=sub.n_v)
            stats.wedges_fd += int(
                (colsum * np.maximum(dv_cur - 1, 0)).sum())
            stats.rho_fd += 1
            surv_mask = alive & ~l_mask
            if not surv_mask.any():
                break                   # subset fully drained on host
            if lvl == levels - 1:
                # last hoisted level: the device applies its delta
                out.append(dict(
                    t, surv=np.where(surv_mask)[0],
                    l1=np.where(l_mask)[0], cap1=cap_l,
                    sup_surv=sup[surv_mask],
                ))
                break
            # fold this level's delta host-side and keep hoisting
            if a_host is None:
                a_host = np.zeros((n, sub.n_v), np.float64)
                a_host[sub.edges_u, sub.edges_v] = 1.0
            w = a_host[surv_mask] @ a_host[l_mask].T
            delta = (w * (w - 1.0) * 0.5).sum(axis=1)
            sup[surv_mask] = np.maximum(sup[surv_mask] - delta, cap_l)
            a_host[l_mask] = 0.0
            dv_cur = dv_cur - colsum
            alive = surv_mask
    return out


def _level_pad(n: int, align: int) -> int:
    """Level-stack padding: power-of-two-ish buckets (coarser buckets merge
    more survivor subgraphs into one stack)."""
    return bucket(n, align)


def _probe_peel_width(group: List[Dict]) -> int:
    """First-sweep level-size probe: the survivor supports' value
    multiplicities are the level sizes the first sweeps peel; the probe
    takes the largest single level AND the bottom-two cumulative mass per
    task.  A larger level at run time takes the mask-form update."""
    probe = 1
    for t in group:
        sup = np.asarray(t["sup_surv"])
        if sup.size == 0:
            continue
        _, counts = np.unique(sup, return_counts=True)
        probe = max(probe, int(counts.max()), int(counts[:2].sum()))
    return probe


def build_level_stack(group: List[Dict], cfg: ReceiptConfig,
                      plan=None) -> Dict:
    """Assemble one shape group into the batched level-peel stacks (host
    work, overlapped with the previous group's device work).

    Two stacks per group: the SURVIVOR stack ``a`` (G, mm, cc) the level
    loop peels, and the first-level stack ``a_l1`` (G, w1, cc) whose delta
    the launcher applies through one kernel-2 call before entering the
    loop.  Group tasks carry the ``pre_peel_tasks`` fields.  ``plan``
    records every stack dimension (the group count too) and supplies the
    measured gather width of the stack shape; either way the stacks are
    sized to the group.
    """
    row_align, col_align, w_align = _aligns(cfg)
    n_g = len(group)
    mm = _level_pad(max(len(t["surv"]) for t in group), row_align)
    cc = _level_pad(max(max(t["sub"].n_v, 1) for t in group), col_align)
    w1 = pad_to_multiple(max(len(t["l1"]) for t in group), w_align)
    if plan is not None:
        mm = plan.quantize_dim("fd_rows", mm)
        cc = plan.quantize_dim("fd_cols", cc)
        w1 = plan.quantize_dim("fd_l1", w1)
        n_g = plan.quantize_dim("fd_groups", n_g)

    a = np.zeros((n_g, mm, cc), np.float32)
    a_l1 = np.zeros((n_g, w1, cc), np.float32)
    sup0 = np.full((n_g, mm), np.inf, np.float64)
    nmem = np.zeros(n_g, np.int32)
    n_l1 = np.zeros(n_g, np.int32)
    los = np.zeros(n_g, np.float64)
    cap1 = np.zeros(n_g, np.float64)
    for k, t in enumerate(group):
        surv, l1 = t["surv"], t["l1"]
        nmem[k] = len(surv)
        n_l1[k] = len(l1)
        los[k] = t["lo"]
        cap1[k] = t["cap1"]
        sup0[k, : len(surv)] = t["sup_surv"]
        s = t["sub"]
        # scatter edges of survivor rows (compacted) and first-level rows
        surv_pos = np.full(s.n_u, -1, np.int64)
        surv_pos[surv] = np.arange(len(surv))
        l1_pos = np.full(s.n_u, -1, np.int64)
        l1_pos[l1] = np.arange(len(l1))
        es = surv_pos[s.edges_u] >= 0
        a[k, surv_pos[s.edges_u[es]], s.edges_v[es]] = 1.0
        ep = l1_pos[s.edges_u] >= 0
        a_l1[k, l1_pos[s.edges_u[ep]], s.edges_v[ep]] = 1.0

    # support-update cost model (the HUC argument applied to FD): pay the
    # (M, M) wedge contraction once when the B2 stack fits the budget,
    # stream sweeps through the grouped kernel when it cannot
    update_mode = "b2" if b2_update(n_g, mm, cfg) else "kernel"

    if cfg.peel_width is not None:
        peel_width = min(bucket(cfg.peel_width, w_align), mm)
    else:
        # a width an earlier same-signature run measured at this stack
        # shape, else the first-sweep level-size probe
        hint = plan.fd_width_hint((mm, cc)) if plan is not None else None
        probe = hint if hint is not None else _probe_peel_width(group)
        peel_width = min(bucket(max(probe, w_align), w_align), mm)

    return dict(
        group=group, a=a, a_l1=a_l1, sup0=sup0, nmem=nmem, n_l1=n_l1,
        los=los, cap1=cap1, dv0=a.sum(axis=1),
        alive0=np.arange(mm)[None, :] < nmem[:, None],
        mm=mm, cc=cc, w1=w1, peel_width=peel_width, update_mode=update_mode,
        padded_cells=n_g * (mm + w1) * cc,
        used_cells=int(sum(len(t["members"]) * max(t["sub"].n_v, 1)
                           for t in group)),
    )


def first_level_delta(a, a_l1, n_l1, sup, cap1, *, backend, blocks,
                      stats=None):
    """Apply the last hoisted level's delta to a survivor stack: ONE
    grouped kernel call (kernel 2; kernel 5 on the sparse backends) sized
    to survivors (output side) x first level (gathered side).  The
    gathered ids start at ``mm`` so no survivor id can equal one (no
    self-mask).

    a (G, mm, cc) and a_l1 (G, w1, cc) stacks, n_l1 (G,) int32 first-level
    sizes, sup (G, mm) supports, cap1 (G,) level caps, all on one device
    (the supports and caps float64 in the engine; ``stats`` counts the
    delta in ``wide_bytes``).
    Returns (supports floored at the cap, the survivor stack's per-row
    staircase extents on the sparse backends, else None).
    """
    g_n, mm, _cc = a.shape
    w1 = a_l1.shape[1]
    dev = a.device
    bi, bj, bk = blocks
    valid1 = torch.arange(w1, device=dev)[None, :] < n_l1[:, None]
    ids_s = torch.arange(mm, dtype=torch.int32, device=dev).expand(g_n, mm)
    ids_l1 = (mm + torch.arange(w1, dtype=torch.int32, device=dev)
              ).expand(g_n, w1)
    if backend in kops.SPARSE_BACKENDS:
        row_ext = ksparse.row_extents_device(a, bk)
        kma = ksparse.tile_extents(row_ext, bi)
        kmb = ksparse.column_extents(a_l1, bj, bk)
    else:
        row_ext = kma = kmb = None
    delta1 = note_wide(stats, kops.butterfly_update_batched(
        a, a_l1, valid1, ids_s, ids_l1, backend=backend, blocks=blocks,
        kmax_a=kma, kmax_b=kmb))
    return torch.maximum(sup - delta1, cap1[:, None]), row_ext


def _note_group_run(built: Dict, max_level_seen: int, stats: RunStats,
                    plan) -> None:
    """Fold one drained group's measured level shape into RunStats and
    the plan."""
    stats.fd_peel_widths.append(int(built["peel_width"]))
    stats.fd_max_levels.append(int(max_level_seen))
    if max_level_seen > built["peel_width"]:
        stats.fd_mask_fallbacks += 1
    if plan is not None:
        plan.note_fd_level((built["mm"], built["cc"]), int(max_level_seen),
                           int(built["peel_width"]))


# ---------------------------------------------------------------------- #
# FD entry point
# ---------------------------------------------------------------------- #
def receipt_fd(
    g: BipartiteGraph,
    subset_id: np.ndarray,
    init_support: np.ndarray,
    bounds: np.ndarray,
    cfg: ReceiptConfig,
    stats: RunStats,
    *,
    device,
    mesh=None,
    plan=None,
) -> np.ndarray:
    """Exact tip numbers by independent peeling of induced subgraphs
    (``plan``: the level stacks' hooks, module docstring).

    ``mesh``: a ``repro_torch.launch.mesh.DeviceMesh`` peels each shape
    group's stacks on the mesh, subsets LPT-assigned to its shard devices
    (``_run_level_groups_mesh``); tip numbers are identical to the
    single-device path, and the per-shard loads are reconciled into
    ``stats.fd_shard_rho`` / ``fd_shard_wedges``.  Requires
    ``fd_mode="level"``.  The span ``fd`` times the whole phase, the
    window of ``stats.time_fd``."""
    if cfg.fd_mode not in ("level", "b2", "matvec"):
        raise ValueError(f"unknown fd_mode {cfg.fd_mode!r}")
    if mesh is not None and cfg.fd_mode != "level":
        raise ValueError(
            "mesh-sharded FD runs the batched level-peel loop; set "
            f"fd_mode='level' (got {cfg.fd_mode!r})")
    if cfg.max_sweeps < 1:
        raise ValueError(
            f"max_sweeps must be >= 1 (got {cfg.max_sweeps}): the valve "
            "bounds one loop invocation; a sub-1 cap makes no progress")
    with span("fd", stats):
        t0 = time.perf_counter()
        theta = np.zeros(g.n_u, np.float64)
        backend = kops.resolve_backend(cfg.backend, device)
        tasks = build_fd_tasks(g, subset_id, bounds, stats)
        if cfg.fd_mode == "level" and mesh is not None:
            theta = _run_level_groups_mesh(tasks, init_support, cfg, stats,
                                           theta, mesh, plan=plan)
        elif cfg.fd_mode == "level":
            theta = _run_level_groups(tasks, init_support, cfg, backend,
                                      stats, theta, device=device, plan=plan)
        else:
            stats.wedges_fd += int(sum(t["wedges"] for t in tasks))
            groups = pack_by_shape(
                tasks,
                size_of=lambda t: (len(t["members"]), max(t["sub"].n_v, 1)),
                weight_of=lambda t: t["wedges"],
                bucket=lambda n: bucket(n, 8),
            )
            stats.fd_groups = len(groups)
            theta = _run_legacy_groups(groups, init_support, cfg, backend,
                                       stats, theta, device=device)
        stats.time_fd = time.perf_counter() - t0
    return theta


def _run_legacy_groups(groups, init_support, cfg, backend, stats, theta, *,
                       device):
    """The legacy engines: one sequential peel per shape group, one
    fetch of its theta."""
    padded = used = 0
    for group in groups:
        mm = max(bucket(max(len(t["members"]) for t in group), 8), 8)
        cc = max(bucket(max(t["sub"].n_v for t in group), 8), 8)
        n_g = len(group)
        sup0 = np.full((n_g, mm), np.inf, np.float64)
        nmem = np.zeros(n_g, np.int64)
        los = np.zeros(n_g, np.float64)
        a_stack = np.zeros((n_g, mm, cc), np.float32)
        for k, t in enumerate(group):
            mems = t["members"]
            nmem[k] = len(mems)
            los[k] = t["lo"]
            sup0[k, : len(mems)] = init_support[mems]
            s = t["sub"]
            a_stack[k, s.edges_u, s.edges_v] = 1.0
        padded += n_g * mm * cc
        used += int(sum(len(t["members"]) * max(t["sub"].n_v, 1)
                        for t in group))

        a_dev = upload(stats, a_stack, device, cfg.dtype)
        sup_dev = upload(stats, sup0, device, SUPPORT_DTYPE)
        nm_dev = upload(stats, nmem, device)
        lo_dev = upload(stats, los, device, SUPPORT_DTYPE)
        if cfg.fd_mode == "b2":
            b2 = note_wide(stats, kops.b2_stack(
                a_dev.to(torch.float32), backend=backend,
                blocks=cfg.kernel_blocks))
            th = _fd_peel_b2(b2, sup_dev, nm_dev, lo_dev)
        else:
            th = _fd_peel_matvec(a_dev, sup_dev, nm_dev, lo_dev)
        th_np = fetch(stats, th)[0]
        stats.rho_fd += int(nmem.sum())       # one sync round per peel step
        for k, t in enumerate(group):
            theta[t["members"]] = th_np[k, : nmem[k]]

    stats.fd_padding_waste = 1.0 - used / padded if padded else 0.0
    return theta


def _run_level_groups(tasks, init_support, cfg, backend, stats, theta, *,
                      device, plan=None):
    """Pre-peel first levels on the host, group the SURVIVOR subgraphs by
    padded shape, and peel each group with the batched level loop —
    double-buffering host stack assembly against device work."""
    blocks = cfg.kernel_blocks

    def launch(built):
        """Uploads, the sparse backends' extents and the first-level delta:
        asynchronous launches.  Returns (device state, padded cells)."""
        fault_point("kernel_launch", KernelBackendError,
                    dispatch="fd_level", backend=backend,
                    group_shape=(built["a"].shape[0], built["mm"]))

        def up(x, dtype):
            return upload(stats, x, device, dtype)

        a_dev = up(built["a"], cfg.dtype)
        sup1, row_ext = first_level_delta(
            a_dev, up(built["a_l1"], cfg.dtype),
            up(built["n_l1"], torch.int32), up(built["sup0"], SUPPORT_DTYPE),
            up(built["cap1"], SUPPORT_DTYPE),
            backend=backend, blocks=blocks, stats=stats)
        return (a_dev, sup1, up(built["alive0"], torch.bool),
                up(built["dv0"], torch.float32),
                up(built["los"], SUPPORT_DTYPE),
                row_ext), built["padded_cells"]

    def drain(built, state):
        """Run the group's level loop to the end (re-entering on a
        ``max_sweeps`` cap-exit) and fetch theta once per invocation."""
        a_dev, sup, alive, dv, lo_dev, row_ext = state
        th_acc = np.zeros(built["alive0"].shape, np.float64)
        prev_alive = built["alive0"]
        max_level_seen = 0
        while True:
            sup, alive, dv, th, rho, wedges, max_lev, _sweeps = (
                batched_level_loop(
                    a_dev, sup, alive, dv, lo_dev, backend=backend,
                    blocks=blocks, peel_width=built["peel_width"],
                    max_sweeps=cfg.max_sweeps,
                    update_mode=built["update_mode"], row_ext=row_ext,
                    stats=stats))
            stats.device_loop_calls += 1
            th_h, alive_h, rho_h, wedges_h, max_lev_h = fetch(
                stats, th, alive, rho, wedges, max_lev)
            alive_h = alive_h.astype(bool)
            d_rho = int(rho_h.sum())
            stats.rho_fd += d_rho
            stats.wedges_fd += int(wedges_h.sum())
            max_level_seen = max(max_level_seen, int(max_lev_h.max()))
            newly_dead = prev_alive & ~alive_h
            th_acc = np.where(newly_dead, th_h, th_acc)
            if not alive_h.any() or d_rho == 0:
                break
            prev_alive = alive_h
        _note_group_run(built, max_level_seen, stats, plan)
        for k, t in enumerate(built["group"]):
            theta[t["members"][t["surv"]]] = th_acc[k, : built["nmem"][k]]

    _pipeline(tasks, init_support, cfg, stats, theta, plan, launch, drain,
              slots_of=lambda chunk: (len(chunk), len(chunk)))
    return theta


def _launch_bytes(chunk: List[Dict], cfg: ReceiptConfig, slots_of):
    """(state, update) bytes of launching ``chunk``, leading tasks of one
    shape group (``fd_state_bytes``, ``fd_update_bytes``): ``slots_of``
    gives the slots the fullest card holds and the slots one level loop
    updates."""
    row_align, col_align, w_align = _aligns(cfg)
    mm = _level_pad(max(len(t["surv"]) for t in chunk), row_align)
    cc = _level_pad(max(max(t["sub"].n_v, 1) for t in chunk), col_align)
    n_slots, n_up = slots_of(chunk)
    return (fd_state_bytes(n_slots, mm, cc),
            fd_update_bytes(n_up, mm, cc, w_align,
                            b2_update(len(chunk), mm, cfg)))


def _fit_launch(rest: List[Dict], held: int, budget: int,
                cfg: ReceiptConfig, slots_of):
    """How many leading tasks of ``rest`` the next launch takes within
    ``budget`` beside ``held`` bytes in flight (the launch before it, not
    yet drained), and whether that one must drain first: the most tasks
    whose stacks fit beside it and, while they drain, beside their own
    update; else, drained first, the most that fit alone; else one."""
    for beside in ((held, 0) if held else (0,)):
        for k in range(len(rest), 0, -1):
            state, update = _launch_bytes(rest[:k], cfg, slots_of)
            if state + update <= budget and state + beside <= budget:
                return k, beside != held
    return 1, bool(held)


def _pipeline(tasks, init_support, cfg, stats, theta, plan, launch, drain,
              slots_of):
    """The shared pipeline of the level peels: pre-peel first levels on the
    host (``pre_peel_tasks``), group the SURVIVOR subgraphs by padded
    shape, then per group build the stacks, ``launch(built) -> (state,
    padded cells)`` (asynchronous) and ``drain(built, state)``; under
    ``cfg.fd_overlap`` a group drains only after the next one is built
    and launched.  A plan's ``padded_bytes`` is a budget the pipeline
    keeps: a group whose stacks would not fit beside the one in flight
    launches in parts (``_fit_launch``; ``slots_of`` as in
    ``_launch_bytes``), and the one in flight drains first where not even
    one more task fits beside it.  Sets ``stats.fd_groups`` (the shape
    groups, however many launches) and ``fd_padding_waste``."""
    row_align, col_align, _ = _aligns(cfg)
    tasks = pre_peel_tasks(tasks, init_support, theta, stats,
                           levels=cfg.fd_prepeel_levels)
    groups = pack_by_shape(
        tasks,
        size_of=lambda t: (len(t["surv"]), max(t["sub"].n_v, 1)),
        weight_of=lambda t: t["wedges"],
        bucket=lambda n: _level_pad(n, row_align),
        bucket_cols=lambda n: _level_pad(n, col_align),
    )
    stats.fd_groups = len(groups)
    budget = plan.padded_bytes if plan is not None else None
    padded = used = 0
    pending = None           # (built, device state) one launch in flight
    held = 0                 # its state + update bytes
    for group in groups:
        rest = group
        while rest:
            k = len(rest)
            if budget is not None:
                k, wait = _fit_launch(rest, held, budget, cfg, slots_of)
                if wait:
                    drain(*pending)
                    pending, held = None, 0
            chunk, rest = rest[:k], rest[k:]
            if budget is not None:
                held = sum(_launch_bytes(chunk, cfg, slots_of))
            built = build_level_stack(chunk, cfg, plan=plan)
            state, cells = launch(built)            # async launches
            padded += cells
            used += built["used_cells"]
            if pending is not None:
                drain(*pending)
            if cfg.fd_overlap:
                pending = (built, state)            # drain AFTER next build
            else:
                drain(built, state)
                held = 0
    if pending is not None:
        drain(*pending)
    stats.fd_padding_waste = 1.0 - used / padded if padded else 0.0


def _run_level_groups_mesh(tasks, init_support, cfg, stats, theta, mesh,
                           plan=None):
    """The mesh FD (DESIGN.md section 4): ``_run_level_groups``'s pipeline
    (host pre-peel, shape-group packing, double-buffered group dispatch)
    with each group's stacks LPT-laid over the mesh's shards
    (``distributed.shard_level_group``, shard loads carried across
    groups) and peeled shard by shard on the shards' devices
    (``distributed.fd_level_launch`` / ``fd_level_run``: the first-level
    delta, then the level loop, on the hand kernels of the backend).
    Per-shard sweeps and wedges accumulate into ``stats.fd_shard_rho`` /
    ``fd_shard_wedges``.  ``device_loop_calls`` counts one per group
    dispatch and one per cap-exit re-entry, as the reference's.  The
    measured-level feedback (``_note_group_run``) is the local path's
    only, as in the reference; the plan's hints apply."""
    from ..distributed import (fd_level_launch, fd_level_run,
                               shard_level_group)

    blocks = cfg.kernel_blocks
    n_shards = mesh.size
    dev0 = mesh.devices[0]
    stats.fd_shards = n_shards
    shard_rho = np.zeros(n_shards, np.int64)
    shard_wedges = np.zeros(n_shards, np.float64)
    lpt_loads = np.zeros(n_shards, np.float64)   # carried across groups

    def launch(built):
        """The LPT layout, each shard's uploads and first-level delta
        (asynchronous launches).  Returns (state, padded cells: the LPT
        padding slots count)."""
        nonlocal lpt_loads
        sharded, slots = shard_level_group(built, n_shards,
                                           init_loads=lpt_loads)
        lpt_loads = lpt_loads + sharded["shard_load"]
        states = fd_level_launch(
            mesh, sharded["a"], sharded["sup"], sharded["alive"],
            sharded["dv"], sharded["lo"], a_l1=sharded["a_l1"],
            n_l1=sharded["n_l1"], cap1=sharded["cap1"], backend=cfg.backend,
            blocks=blocks)
        return ((sharded, slots, states),
                sharded["a"].size + sharded["a_l1"].size)

    def drain(built, state):
        """Every shard's level loop, in turn, re-entered on a
        ``max_sweeps`` cap-exit; one fetch of the gathered results per
        invocation."""
        nonlocal shard_rho, shard_wedges
        sharded, slots, states = state
        per_shard = sharded["per_shard"]
        th_acc = np.zeros(sharded["alive"].shape, np.float64)
        prev_alive = sharded["alive"]
        while True:
            res = fd_level_run(states, update_mode=built["update_mode"],
                               peel_width=built["peel_width"],
                               max_sweeps=cfg.max_sweeps, blocks=blocks,
                               stats=stats)
            stats.device_loop_calls += 1
            th, rho, wedges = (torch.cat([p.to(dev0) for p in parts])
                               for parts in zip(*res))
            alive = torch.cat([st["alive"].to(dev0) for st in states])
            th_h, alive_h, rho_h, wedges_h = fetch(stats, th, alive, rho,
                                                   wedges)
            alive_h = alive_h.astype(bool)
            d_rho = int(rho_h.sum())
            stats.rho_fd += d_rho
            stats.wedges_fd += int(wedges_h.sum())
            shard_rho += rho_h.astype(np.int64).reshape(
                n_shards, per_shard).sum(axis=1)
            shard_wedges += wedges_h.reshape(n_shards, per_shard).sum(axis=1)
            newly_dead = prev_alive & ~alive_h
            th_acc = np.where(newly_dead, th_h, th_acc)
            if not alive_h.any() or d_rho == 0:
                break
            prev_alive = alive_h
            for i, st in enumerate(states):
                st["live"] = bool(alive_h[i * per_shard:
                                          (i + 1) * per_shard].any())
        for s, t_idx in enumerate(slots):
            if t_idx < 0:
                continue
            t = built["group"][t_idx]
            nm = int(built["nmem"][t_idx])
            theta[t["members"][t["surv"]]] = th_acc[s, :nm]

    def slots_of(chunk):
        """The fullest card's slots and one shard's: the LPT layout
        ``launch`` will give ``chunk`` after the loads so far."""
        _, per_shard = lpt_shard_plan([t["wedges"] for t in chunk],
                                      n_shards, list(lpt_loads))
        return on_card * per_shard, per_shard

    on_card = max(mesh.shards_per_device().values())
    _pipeline(tasks, init_support, cfg, stats, theta, plan, launch, drain,
              slots_of)
    stats.fd_shard_rho = [int(x) for x in shard_rho]
    stats.fd_shard_wedges = [float(x) for x in shard_wedges]
    return theta
