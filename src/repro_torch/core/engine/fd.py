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
version), ``"matvec"`` recomputes one B2 row per step.  The mesh path
arrives with the distributed slice (ROADMAP.md, queue 1).

With a ``plan`` (``repro_torch.api.ExecutionPlan``) the level stacks take
the reference's two hooks: every stack dimension (``fd_rows``,
``fd_cols``, ``fd_l1``, ``fd_groups``) is recorded through
``plan.quantize_dim`` and left as built (no jit cache to keep warm), and
the gather width of a stack shape is the one an earlier run measured
(``plan.fd_width_hint``; a level that outgrows it takes the mask-form
update).  Each drained group records its
largest level back (``plan.note_fd_level``).  Theta is the same either
way.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ...api.errors import KernelBackendError
from ...api.faults import fault_point
from ...kernels import butterfly_sparse as ksparse
from ...kernels import ops as kops
from ..graph import BipartiteGraph, pad_to_multiple
from ..scheduler import pack_by_shape
from .peel_loop import (
    _INF,
    ReceiptConfig,
    RunStats,
    batched_level_loop,
    bucket,
    fetch,
)

__all__ = ["receipt_fd", "build_fd_tasks", "pre_peel_tasks",
           "build_level_stack"]


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
        b2 = w * (w - 1.0) * 0.5
        return torch.where(cols[None, :] == u[:, None], 0.0, b2)

    return _sequential_peel(sup0, n_members, lo, b2_row)


# ---------------------------------------------------------------------- #
# task construction + scheduling
# ---------------------------------------------------------------------- #
def build_fd_tasks(g: BipartiteGraph, subset_id: np.ndarray,
                   bounds: np.ndarray, stats: RunStats) -> List[Dict]:
    """Induce each subset's subgraph (the paper's "only traverse its
    wedges" saving) and record per-subset size/wedge-bound stats."""
    n_sub = int(subset_id.max()) + 1 if subset_id.size else 0
    tasks = []
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
    if cfg.fd_update_mode == "auto":
        update_mode = ("b2" if n_g * mm * mm <= cfg.fd_b2_cells
                       else "kernel")
    else:
        update_mode = cfg.fd_update_mode

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
    plan=None,
) -> np.ndarray:
    """Exact tip numbers by independent peeling of induced subgraphs
    (``plan``: the level stacks' hooks, module docstring)."""
    if cfg.fd_mode not in ("level", "b2", "matvec"):
        raise ValueError(f"unknown fd_mode {cfg.fd_mode!r}")
    if cfg.max_sweeps < 1:
        raise ValueError(
            f"max_sweeps must be >= 1 (got {cfg.max_sweeps}): the valve "
            "bounds one loop invocation; a sub-1 cap makes no progress")
    t0 = time.perf_counter()
    theta = np.zeros(g.n_u, np.float64)
    backend = kops.resolve_backend(cfg.backend, device)
    tasks = build_fd_tasks(g, subset_id, bounds, stats)
    if cfg.fd_mode == "level":
        theta = _run_level_groups(tasks, init_support, cfg, backend, stats,
                                  theta, device=device, plan=plan)
    else:
        stats.wedges_fd += int(sum(t["wedges"] for t in tasks))
        groups = pack_by_shape(
            tasks,
            size_of=lambda t: (len(t["members"]), max(t["sub"].n_v, 1)),
            weight_of=lambda t: t["wedges"],
            bucket=lambda n: bucket(n, 8),
        )
        stats.fd_groups = len(groups)
        theta = _run_legacy_groups(groups, init_support, cfg, backend, stats,
                                   theta, device=device)
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

        a_dev = torch.as_tensor(a_stack).to(device=device, dtype=cfg.dtype)
        sup_dev = torch.as_tensor(sup0).to(device=device, dtype=cfg.dtype)
        nm_dev = torch.as_tensor(nmem).to(device)
        lo_dev = torch.as_tensor(los).to(device=device, dtype=cfg.dtype)
        if cfg.fd_mode == "b2":
            b2 = kops.b2_stack(a_dev.to(torch.float32), backend=backend,
                               blocks=cfg.kernel_blocks).to(cfg.dtype)
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
    bi, bj, bk = blocks
    sparse = backend in kops.SPARSE_BACKENDS
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

    padded = used = 0
    pending = None           # (built, device state) one group in flight

    def launch(built):
        """Uploads, the sparse backends' extents and the first-level delta:
        asynchronous launches."""
        g_n, mm, w1 = built["a"].shape[0], built["mm"], built["w1"]
        fault_point("kernel_launch", KernelBackendError,
                    dispatch="fd_level", backend=backend,
                    group_shape=(g_n, mm))

        def up(x, dtype):
            return torch.as_tensor(x).to(device=device, dtype=dtype)

        a_dev = up(built["a"], cfg.dtype)
        sup_dev = up(built["sup0"], cfg.dtype)
        # first-level delta: ONE grouped kernel call sized to survivors
        # (output side) x first level (gathered side); the gathered ids
        # start at mm so no survivor id can equal one (no self-mask)
        a_l1 = up(built["a_l1"], cfg.dtype)
        valid1 = (torch.arange(w1, device=device)[None, :]
                  < up(built["n_l1"], torch.int32)[:, None])
        ids_s = torch.arange(mm, dtype=torch.int32, device=device).expand(
            g_n, mm)
        ids_l1 = (mm + torch.arange(w1, dtype=torch.int32, device=device)
                  ).expand(g_n, w1)
        if sparse:
            row_ext = ksparse.row_extents_device(a_dev, bk)
            kma = ksparse.tile_extents(row_ext, bi)
            kmb = ksparse.column_extents(a_l1, bj, bk)
        else:
            row_ext = kma = kmb = None
        delta1 = kops.butterfly_update_batched(
            a_dev, a_l1, valid1, ids_s, ids_l1, backend=backend,
            blocks=blocks, kmax_a=kma, kmax_b=kmb)
        cap1 = up(built["cap1"], cfg.dtype)
        sup1 = torch.maximum(sup_dev - delta1, cap1[:, None])
        return (a_dev, sup1, up(built["alive0"], torch.bool),
                up(built["dv0"], torch.float32),
                up(built["los"], torch.float32), row_ext)

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

    for group in groups:
        built = build_level_stack(group, cfg, plan=plan)
        padded += built["padded_cells"]
        used += built["used_cells"]
        state = launch(built)                   # async launches
        if pending is not None:
            drain(*pending)
        if cfg.fd_overlap:
            pending = (built, state)            # drain AFTER next build
        else:
            drain(built, state)
    if pending is not None:
        drain(*pending)

    stats.fd_padding_waste = 1.0 - used / padded if padded else 0.0
    return theta
