"""Distributed RECEIPT over an in-process device mesh (port of
``repro.core.distributed``; DESIGN.md section 4).

The mesh is a ``launch.mesh.DeviceMesh``: one process drives every
device, as the reference's single-controller ``Mesh`` does.  A shard's
data lives on that shard's device, and the collectives are explicit
copies between shard devices (``.to(device)``) whose sums run in a fixed
shard order; in the f32 integer regime (DESIGN.md section 8) no order
changes a bit.

CD layout (mesh axes ``("pod", "data", "model")`` or ``("data",
"model")``; an absent axis has size 1):

    A        (n_u, n_v)  rows over the dp axes (pod, data), cols over model
    support  (n_u,)      over the dp axes (on the model-0 device of a row)
    peel set A_S         gathered rows, cols over model

One CD sweep, chunk by chunk of the peel set (the reference's ``scan``):

    a_s   <- owner-masked row gather, summed over the dp shards
    W_par <- the local product over this shard's columns
    W     <- reduce-scatter over ``model`` on the chunk dimension
    delta <- C(W, 2) epilogue with the self-pair mask, then a sum over
             ``model`` of the (n_u_local,) partials
    support' = max(support - delta, lo) on the rows left alive

Where ``model`` has size 1 the local product and its epilogue are ONE call
of kernel 1's peel form (``kops.butterfly_update``: the shard's rows with
their global ids against the gathered rows), the hand kernel on a CUDA
tensor.  Where ``model`` > 1, C(W, 2) needs the summed product, so the
partial product stays a ``torch.matmul`` of the 0/1 operands (exact under
TF32 too) and the epilogue is plain: the reference computes this product
outside any Pallas kernel as well.  ``distributed_cd_sweep``'s ``impl``
(``"gspmd"`` / ``"shardmap"``) names the reference's two schedules; both
run this one here and give the same answer.

FD is a stack of independent subsets: ``distributed_fd_level_peel`` splits
the slot stack into ``mesh.size`` contiguous slices, one per shard device,
and each shard replays the single-device launch sequence
(`engine/fd.py`): the first-level delta (kernel 2, or kernel 5 on the
sparse backends), then ``batched_level_loop`` (kernel 3 in ``b2`` mode,
kernel 2 or 5 in ``kernel`` mode).  No shard reads another's state; the
shards run one after another from this thread, and each reads once per
sweep (``batched_level_loop``).  ``shard_level_group`` lays a shape group
out with ``scheduler.lpt_shard_plan`` (Graham's rule, the paper's
workload-aware scheduling, Fig. 3).

``lower_cd_sweep`` and ``lower_fd_stack`` cost one production-scale step
for the dry run (``launch/dryrun.py``): the step runs on meta pieces under
``utils.op_cost.OpCost``, each shard's work booked to its mesh position,
and the exchanges above recorded as collectives.  One ``_CDShards.sweep``
stands for both of the reference's schedules (``"shardmap"`` and
``"gspmd"``), which are one schedule here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels import butterfly_sparse as ksparse
from ..kernels import ops as kops
from ..launch.mesh import (NamedSharding, PartitionSpec, at_position,
                           axis_size, check_mesh, dp_axes, record_collective)
from .engine.fd import _fd_peel_b2, first_level_delta
from .engine.peel_loop import batched_level_loop, fetch
from .scheduler import lpt_shard_plan

__all__ = [
    "distributed_butterfly_support",
    "distributed_cd_sweep",
    "distributed_cd_fused_loop",
    "shard_fd_stack",
    "shard_level_group",
    "distributed_fd_level_peel",
    "fd_level_launch",
    "fd_level_run",
    "fd_stack_step",
    "lower_cd_sweep",
    "lower_fd_stack",
]

_F32 = torch.float32
_CD_AXES = ("pod", "data", "model")
_IMPLS = ("gspmd", "shardmap")


# --------------------------------------------------------------------- #
# CD: the row/column layout and its collectives
# --------------------------------------------------------------------- #
class _CDShards:
    """``A`` split over a mesh: ``grid[d][m]`` is the device of dp shard
    ``d`` and model shard ``m`` (``pos[d][m]`` its mesh position),
    ``a[d][m]`` its block (f32 0/1), ``ids[d][m]`` the block's global row
    ids (int32).  Each shard's work runs ``at_position`` of its shard, and
    every exchange is recorded (``record_collective``)."""

    def __init__(self, mesh, a):
        check_mesh(mesh)
        extra = [n for n in mesh.axis_names if n not in _CD_AXES]
        if extra:
            raise ValueError(f"the CD layout shards over {_CD_AXES}; the "
                             f"mesh has axes {extra} too")
        dp = dp_axes(mesh)
        self.dp = dp
        self.n_dp, self.n_tp = axis_size(mesh, dp), axis_size(mesh, "model")
        a = torch.as_tensor(a)
        self.n_u, self.n_v = a.shape
        if self.n_u % self.n_dp or self.n_v % self.n_tp:
            raise ValueError(
                f"A {tuple(a.shape)} does not split evenly over "
                f"{self.n_dp} dp x {self.n_tp} model shards")
        self.n_loc = self.n_u // self.n_dp
        c_loc = self.n_v // self.n_tp
        self.pos = []
        for d in range(self.n_dp):
            coords, rem = {}, d
            for name in reversed(dp):
                n = mesh.shape[name]
                coords[name], rem = rem % n, rem // n
            self.pos.append([
                mesh.flat_at(**coords, **({"model": m}
                                          if "model" in mesh.shape else {}))
                for m in range(self.n_tp)])
        self.grid = [[mesh.devices[k] for k in row] for row in self.pos]
        self.out_device = mesh.devices[0]
        self.a, self.ids = [], []
        for d, row in enumerate(self.grid):
            r0 = d * self.n_loc
            self.a.append([
                a[r0:r0 + self.n_loc, m * c_loc:(m + 1) * c_loc].to(
                    device=dev, dtype=_F32).contiguous()
                for m, dev in enumerate(row)])
            self.ids.append([
                torch.arange(r0, r0 + self.n_loc, dtype=torch.int32,
                             device=dev) for dev in row])

    # ---- vectors over the dp shards (kept on each row's model-0 device)
    def split(self, v, dtype):
        v = torch.as_tensor(v)
        return [v[d * self.n_loc:(d + 1) * self.n_loc].to(
            device=row[0], dtype=dtype) for d, row in enumerate(self.grid)]

    def join(self, parts):
        """All-gather of dp-sharded vectors onto the mesh's first
        device."""
        out = torch.cat([p.to(self.out_device) for p in parts])
        record_collective("all-gather", out.numel() * out.element_size(),
                          self.n_dp, positions=[r[0] for r in self.pos],
                          axes=self.dp)
        return out

    # ---- collectives
    def gather_rows(self, rows):
        """Owner-masked row gather over the dp axes: per model shard m,
        the (n_s, n_v / n_tp) rows ``A[rows]`` summed over the dp shards
        in order (exactly one owner per row), then copied to every
        device of that model column.  Returns ``a_s[d][m]``."""
        out = [[None] * self.n_tp for _ in range(self.n_dp)]
        for m in range(self.n_tp):
            acc = None
            for d in range(self.n_dp):
                dev = self.grid[d][m]
                with at_position(self.pos[d][m]):
                    local = rows.to(dev).long() - d * self.n_loc
                    mine = (local >= 0) & (local < self.n_loc)
                    part = torch.where(
                        mine[:, None],
                        self.a[d][m][local.clamp(0, self.n_loc - 1)], 0.0)
                    part = part.to(self.grid[0][m])
                    acc = part if acc is None else acc + part
            record_collective("all-reduce", acc.numel() * acc.element_size(),
                              self.n_dp,
                              positions=[r[m] for r in self.pos],
                              axes=self.dp)
            for d in range(self.n_dp):
                out[d][m] = acc.to(self.grid[d][m])
        return out

    def reduce_scatter_model(self, d, parts):
        """Sum the (n_loc, csz) partial products of dp shard ``d`` over
        ``model``, shard m keeping columns [m csz/n_tp, (m+1) csz/n_tp)."""
        scat = parts[0].shape[1] // self.n_tp
        out = []
        for m in range(self.n_tp):
            dev = self.grid[d][m]
            acc = None
            for i, p in enumerate(parts):
                with at_position(self.pos[d][i]):
                    blk = p[:, m * scat:(m + 1) * scat].to(dev)
                    acc = blk if acc is None else acc + blk
            out.append(acc)
        record_collective("reduce-scatter",
                          out[0].numel() * out[0].element_size(), self.n_tp,
                          positions=self.pos[d], axes=("model",))
        return out

    def sum_model(self, d, parts):
        """Sum of dp shard ``d``'s per-model partials, on its model-0
        device."""
        acc = None
        for i, p in enumerate(parts):
            with at_position(self.pos[d][i]):
                p = p.to(self.grid[d][0])
                acc = p if acc is None else acc + p
        # a reduce onto the model-0 device, costed as the all-reduce the
        # reference's psum is
        record_collective("all-reduce", acc.numel() * acc.element_size(),
                          self.n_tp, positions=self.pos[d], axes=("model",))
        return acc

    # ---- one sweep's support delta
    def delta(self, rows, valid, chunk: int):
        """Per dp shard, ``sum_{j: rows[j] != i} valid[j] C(W[i, j], 2)``
        with W = A A_S^T, chunk by chunk of the peel set."""
        n_s = int(rows.shape[0])
        n_chunks = max(-(-n_s // chunk), 1)
        csz = -(-max(n_s, 1) // n_chunks)
        csz = -(-csz // self.n_tp) * self.n_tp
        pad = n_chunks * csz - n_s
        dev0 = self.out_device
        rows = torch.cat([rows.to(dev0, torch.int32),
                          torch.zeros(pad, dtype=torch.int32, device=dev0)])
        valid = torch.cat([valid.to(dev0, _F32),
                           torch.zeros(pad, dtype=_F32, device=dev0)])
        acc = [torch.zeros(self.n_loc, dtype=_F32, device=row[0])
               for row in self.grid]
        for c in range(n_chunks):
            rows_c = rows[c * csz:(c + 1) * csz]
            valid_c = valid[c * csz:(c + 1) * csz]
            a_s = self.gather_rows(rows_c)
            for d, row in enumerate(self.grid):
                if self.n_tp == 1:
                    dev = row[0]
                    with at_position(self.pos[d][0]):
                        part = kops.butterfly_update(
                            self.a[d][0], a_s[d][0], valid_c.to(dev),
                            self.ids[d][0], rows_c.to(dev))
                else:
                    w_par = []
                    for m in range(self.n_tp):
                        with at_position(self.pos[d][m]):
                            w_par.append(torch.matmul(self.a[d][m],
                                                      a_s[d][m].T))
                    w = self.reduce_scatter_model(d, w_par)
                    scat = csz // self.n_tp
                    parts = []
                    for m, dev in enumerate(row):
                        with at_position(self.pos[d][m]):
                            sl = slice(m * scat, (m + 1) * scat)
                            rows_s = rows_c[sl].to(dev)
                            valid_s = valid_c[sl].to(dev)
                            b2 = w[m] * (w[m] - 1.0) * 0.5
                            keep = ((self.ids[d][m][:, None]
                                     != rows_s[None, :]).to(_F32)
                                    * valid_s[None, :])
                            # a masked sum, not a product: full f32
                            # whatever the TF32 setting (the entries pass
                            # 2048)
                            parts.append((b2 * keep).sum(dim=1))
                    part = self.sum_model(d, parts)
                with at_position(self.pos[d][0]):
                    acc[d] = acc[d] + part
        return acc

    def sweep(self, support, alive, rows, valid, lo, chunk: int):
        """One CD sweep on dp-sharded ``support``/``alive`` lists: the
        delta of the valid ``rows``, those rows marked dead, the
        survivors' supports floored at ``lo``."""
        delta = self.delta(rows, valid, chunk)
        out_s, out_a = [], []
        for d, row in enumerate(self.grid):
            with at_position(self.pos[d][0]):
                s, a = self._sweep_shard(d, row[0], support, alive, rows,
                                         valid, lo, delta)
            out_s.append(s)
            out_a.append(a)
        return out_s, out_a

    def _sweep_shard(self, d, dev, support, alive, rows, valid, lo, delta):
        """Dp shard ``d``'s part of a sweep: its valid peel rows marked
        dead, its survivors' supports less ``delta`` floored at ``lo``."""
        local = rows.to(dev).long() - d * self.n_loc
        mine = ((local >= 0) & (local < self.n_loc)
                & (valid.to(dev) > 0.5))
        peeled = torch.zeros(self.n_loc, dtype=torch.int8, device=dev)
        peeled = peeled.scatter_reduce(
            0, local.clamp(0, self.n_loc - 1), mine.to(torch.int8),
            "amax").to(torch.bool) & alive[d]
        alive_after = alive[d] & ~peeled
        lo_t = torch.as_tensor(lo, dtype=_F32, device=dev)
        return torch.where(
            alive_after, torch.maximum(support[d] - delta[d], lo_t),
            support[d]), alive_after


def distributed_cd_sweep(mesh, a, support, alive, rows, valid, lo,
                         impl: str = "gspmd", chunk: int = 16384):
    """One CD sweep on a live mesh: update supports for a gathered peel
    set (``rows`` (n_s,) global ids, ``valid`` (n_s,) 1.0 on real peel
    rows; padding slots may point anywhere).  Returns (support, alive),
    gathered on the mesh's first device."""
    if impl not in _IMPLS:
        raise ValueError(f"impl {impl!r}: one of {_IMPLS}")
    sh = _CDShards(mesh, a)
    rows = torch.as_tensor(rows)
    valid = torch.as_tensor(valid)
    sup, alv = sh.sweep(sh.split(support, _F32), sh.split(alive, torch.bool),
                        rows, valid, lo, chunk)
    return sh.join(sup), sh.join(alv)


def distributed_butterfly_support(mesh, a, s, *, chunk: int = 16384):
    """Counting / HUC recount on a live mesh:
    ``support[i] = sum_{j != i} [s_j > 0.5] C(W_ij, 2)``, every row
    gathered as the peel set (at ``model`` = 1, kernel 1 with the shard's
    rows as A and every row as B).  Gathered on the mesh's first
    device."""
    sh = _CDShards(mesh, a)
    dev0 = sh.out_device
    s = torch.as_tensor(s).to(dev0)
    rows = torch.arange(sh.n_u, dtype=torch.int32, device=dev0)
    return sh.join(sh.delta(rows, (s > 0.5).to(_F32), chunk))


def distributed_cd_fused_loop(mesh, a, support, alive, hi, lo, *,
                              peel_width: int, max_sweeps: int = 100_000,
                              chunk: int = 16384, stats=None):
    """A whole CD range loop on a live mesh: peel everything with support
    < ``hi`` until the range drains.  Each sweep reads the peel-set size
    once (counted in ``stats.host_round_trips``); a set wider than the
    ``peel_width`` buffer raises the overflow flag and stops without
    sweeping, as the reference's loop does.  The peel rows are the
    ascending global ids of the set, padded with row 0.

    Returns (support, alive, rho, overflow): the vectors gathered on the
    mesh's first device, ``rho`` the sweeps run, ``overflow`` a bool."""
    sh = _CDShards(mesh, a)
    sup, alv = sh.split(support, _F32), sh.split(alive, torch.bool)
    hi = float(hi)
    width = torch.arange(peel_width, device=sh.out_device)
    rho, overflow = 0, False
    while rho < max_sweeps:
        peel = _peel_mask(sh, sup, alv, hi)
        n_peel = int(fetch(stats, peel.sum())[0])
        if n_peel == 0:
            break
        if n_peel > peel_width:
            overflow = True
            break
        rows, valid = _peel_rows(peel, n_peel, width)
        sup, alv = sh.sweep(sup, alv, rows, valid, lo, chunk)
        rho += 1
    return sh.join(sup), sh.join(alv), rho, overflow


def _peel_mask(sh, sup, alv, hi):
    """The alive rows below ``hi``, joined on the mesh's first device."""
    parts = []
    for d, (sp, al) in enumerate(zip(sup, alv)):
        with at_position(sh.pos[d][0]):
            parts.append(al & (sp < hi))
    return sh.join(parts)


def _peel_rows(peel, n_peel: int, width):
    """The range loop's peel buffer: the ascending global ids of the
    ``n_peel`` rows of ``peel``, padded with row 0 to ``len(width)``, and
    their validity (f32)."""
    n = width.numel()
    order = torch.argsort((~peel).to(torch.int8), stable=True)
    order = order[:n].to(torch.int32)
    if order.numel() < n:
        order = torch.cat([order, torch.zeros(
            n - order.numel(), dtype=torch.int32, device=peel.device)])
    valid = width < n_peel
    return torch.where(valid, order, 0), valid.to(_F32)


# --------------------------------------------------------------------- #
# FD: LPT layout of a slot stack (host numpy)
# --------------------------------------------------------------------- #
def shard_fd_stack(a_stack, sup0, nmem, lo, weights, n_shards):
    """Reorder + pad an FD task stack so contiguous equal-size shards are
    LPT-balanced (``scheduler.lpt_shard_plan``).

    a_stack (G, M, C); sup0 (G, M); nmem (G,); lo (G,); weights (G,)
    per-task wedge counts.  Returns (a, sup, alive, dv, lo, slots) where
    the leading dim is ``n_shards * per_shard`` and ``slots[i]`` is the
    original task index occupying stack slot i (-1 = padding slot, which
    the level loop treats as an already-finished group).
    """
    _g_n, mm, cc = a_stack.shape
    slots, per_shard = lpt_shard_plan(list(weights), n_shards)
    n_slots = n_shards * per_shard
    a = np.zeros((n_slots, mm, cc), np.float32)
    sup = np.full((n_slots, mm), np.inf, np.float32)
    alive = np.zeros((n_slots, mm), bool)
    lo_out = np.zeros(n_slots, np.float32)
    for s, t in enumerate(slots):
        if t < 0:
            continue
        a[s] = a_stack[t]
        sup[s] = sup0[t]
        alive[s, : int(nmem[t])] = True
        lo_out[s] = lo[t]
    dv = a.sum(axis=1)
    return a, sup, alive, dv, lo_out, np.asarray(slots)


def shard_level_group(built: dict, n_shards: int, init_loads=None):
    """Reorder one FD shape group's level stacks into the LPT shard layout.

    ``built`` is ``engine/fd.build_level_stack`` output.  Tasks are
    LPT-assigned to ``n_shards`` equal-size contiguous shards by their
    static wedge bound; ``init_loads`` carries the shard loads across
    shape groups, so the whole run balances, not just each group.  Padding
    slots are dead groups (``alive`` all False, ``sup`` all inf).

    Returns (arrays, slots): ``arrays`` has the ``distributed_fd_level_peel``
    inputs plus ``per_shard`` and ``shard_load`` (this group's static
    wedge mass per shard); ``slots[s]`` is the group-list index occupying
    stack slot ``s`` (-1 = padding).
    """
    group = built["group"]
    weights = [t["wedges"] for t in group]
    slots, per_shard = lpt_shard_plan(weights, n_shards, init_loads)
    n_slots = n_shards * per_shard
    mm, cc, w1 = built["mm"], built["cc"], built["w1"]
    a = np.zeros((n_slots, mm, cc), np.float32)
    a_l1 = np.zeros((n_slots, w1, cc), np.float32)
    sup = np.full((n_slots, mm), np.inf, np.float32)
    alive = np.zeros((n_slots, mm), bool)
    n_l1 = np.zeros(n_slots, np.int32)
    cap1 = np.full(n_slots, -np.inf, np.float32)
    lo = np.zeros(n_slots, np.float32)
    for s, t in enumerate(slots):
        if t < 0:
            continue
        a[s] = built["a"][t]
        a_l1[s] = built["a_l1"][t]
        sup[s] = built["sup0"][t]
        alive[s] = built["alive0"][t]
        n_l1[s] = built["n_l1"][t]
        cap1[s] = built["cap1"][t]
        lo[s] = built["los"][t]
    dv = a.sum(axis=1)
    shard_load = np.array([
        sum(weights[t] for t in slots[i * per_shard:(i + 1) * per_shard]
            if t >= 0)
        for i in range(n_shards)
    ], np.float64)
    return dict(a=a, a_l1=a_l1, sup=sup, alive=alive, dv=dv, n_l1=n_l1,
                cap1=cap1, lo=lo, per_shard=per_shard,
                shard_load=shard_load), np.asarray(slots)


# --------------------------------------------------------------------- #
# FD: the sharded level peel
# --------------------------------------------------------------------- #
def fd_level_launch(mesh, a, sup, alive, dv, lo, *, a_l1=None, n_l1=None,
                    cap1=None, backend: Optional[str] = None,
                    blocks=kops.DEFAULT_BLOCKS) -> List[Dict]:
    """Place each shard's slice of the slot stack on its device and apply
    the first-level delta there (asynchronous launches; no read).

    Inputs are the ``shard_fd_stack`` / ``shard_level_group`` layout,
    leading dim divisible by ``mesh.size``; ``a_l1``/``n_l1``/``cap1``
    carry the host pre-peel's first level (omitted: no delta).  Returns
    one state per shard (``a``, ``sup``, ``alive``, ``dv``, ``lo``,
    ``row_ext`` on its device, ``backend``, and ``live``: whether any row
    is alive, known on the host)."""
    check_mesh(mesh)
    n_slots = int(np.shape(a)[0])
    if n_slots % mesh.size:
        raise ValueError(f"{n_slots} stack slots do not split over "
                         f"{mesh.size} shards")
    per = n_slots // mesh.size
    alive_host = np.asarray(torch.as_tensor(alive).cpu(), bool)
    states = []
    for i, dev in enumerate(mesh.devices):
        sl = slice(i * per, (i + 1) * per)

        def up(x, dtype, dev=dev, sl=sl):
            return torch.as_tensor(x[sl]).to(device=dev, dtype=dtype)

        be = kops.resolve_backend(backend, dev)
        a_d = up(a, _F32).contiguous()
        sup_d = up(sup, _F32)
        row_ext = None
        if a_l1 is not None:
            sup_d, row_ext = first_level_delta(
                a_d, up(a_l1, _F32).contiguous(), up(n_l1, torch.int32),
                sup_d, up(cap1, _F32), backend=be, blocks=blocks)
        elif be in kops.SPARSE_BACKENDS:
            row_ext = ksparse.row_extents_device(a_d, blocks[2])
        states.append(dict(a=a_d, sup=sup_d, alive=up(alive, torch.bool),
                           dv=up(dv, _F32), lo=up(lo, _F32),
                           row_ext=row_ext, backend=be,
                           live=bool(alive_host[sl].any())))
    return states


def fd_level_run(states: Sequence[Dict], *, update_mode: str,
                 peel_width: Optional[int], max_sweeps: int,
                 blocks=kops.DEFAULT_BLOCKS, stats=None):
    """Run every shard's level loop, one shard after another; a shard
    with no live row is skipped (its loop would exit at once).  Each
    state's ``sup``/``alive``/``dv`` become the carried state (a
    ``max_sweeps`` cap-exit re-enters from them).  Returns per shard
    (theta, rho, wedges) on its device."""
    out = []
    for st in states:
        g_n, mm, _cc = st["a"].shape
        dev = st["a"].device
        if not st["live"]:
            out.append((torch.zeros((g_n, mm), dtype=_F32, device=dev),
                        torch.zeros(g_n, dtype=torch.int32, device=dev),
                        torch.zeros(g_n, dtype=_F32, device=dev)))
            continue
        pw = mm if peel_width is None else min(peel_width, mm)
        (st["sup"], st["alive"], st["dv"], theta, rho, wedges, _max_level,
         _sweeps) = batched_level_loop(
            st["a"], st["sup"], st["alive"], st["dv"], st["lo"],
            backend=st["backend"], blocks=blocks, peel_width=pw,
            max_sweeps=max_sweeps, update_mode=update_mode,
            row_ext=st["row_ext"], stats=stats)
        out.append((theta, rho, wedges))
    return out


def distributed_fd_level_peel(mesh, a, sup, alive, dv, lo, *, a_l1=None,
                              n_l1=None, cap1=None, update_mode: str = "b2",
                              peel_width: Optional[int] = None,
                              max_sweeps: int = 100_000,
                              full_state: bool = False,
                              backend: Optional[str] = None,
                              blocks=kops.DEFAULT_BLOCKS):
    """Run the sharded FD level peel on a live mesh.

    Inputs are the ``shard_fd_stack`` / ``shard_level_group`` layout
    (leading dim divisible by ``mesh.size``); ``a_l1``/``n_l1``/``cap1``
    the host pre-peel's first level (optional).  Returns (theta, rho,
    wedges) per stack slot, or with ``full_state=True`` the carried state
    (sup, alive, dv, theta, rho, wedges), each gathered over the shards
    onto the mesh's first device.  The caller maps slots back to tasks
    through the plan's ``slots``."""
    states = fd_level_launch(mesh, a, sup, alive, dv, lo, a_l1=a_l1,
                             n_l1=n_l1, cap1=cap1, backend=backend,
                             blocks=blocks)
    res = fd_level_run(states, update_mode=update_mode,
                       peel_width=peel_width, max_sweeps=max_sweeps,
                       blocks=blocks)
    dev0 = mesh.devices[0]

    def cat(parts):
        return torch.cat([p.to(dev0) for p in parts])

    theta, rho, wedges = (cat(x) for x in zip(*res))
    if full_state:
        return (cat([s["sup"] for s in states]),
                cat([s["alive"] for s in states]),
                cat([s["dv"] for s in states]), theta, rho, wedges)
    return theta, rho, wedges


def fd_stack_step(a_stack, sup0, n_members, lo, *,
                  blocks=kops.DEFAULT_BLOCKS):
    """Peel a stack of independent induced subgraphs one vertex per step
    (the legacy sequential FD): B2 from kernel 3, then the sequential
    peel of ``engine/fd._fd_peel_b2``.

    a_stack (G, M, C); sup0 (G, M); n_members (G,); lo (G,), tensors on
    one device.  Returns theta (G, M)."""
    a_stack = torch.as_tensor(a_stack)
    dev = a_stack.device
    b2 = kops.b2_stack(a_stack.to(_F32), blocks=blocks)
    return _fd_peel_b2(b2, torch.as_tensor(sup0).to(dev, _F32),
                       torch.as_tensor(n_members).to(dev),
                       torch.as_tensor(lo).to(dev, _F32))


# --------------------------------------------------------------------- #
# the dry run's steps (costed over meta pieces)
# --------------------------------------------------------------------- #
_META = torch.device("meta")
_CHUNK = 16384          # the peel-set chunk of the sweeps' defaults


def _meta_mesh(mesh):
    check_mesh(mesh)
    if any(d.type != "meta" for d in mesh.devices):
        raise ValueError("a step is costed over a mesh of meta positions "
                         "(make_mesh(..., devices=[torch.device('meta')] "
                         "* n))")
    return mesh


def _piece_bytes(mesh, spec, shape, dtype) -> int:
    n = 1
    for k in NamedSharding(mesh, PartitionSpec(*spec)).shard_shape(shape):
        n *= k
    return n * torch.empty((), dtype=dtype).element_size()


def lower_cd_sweep(mesh, *, n_u: int, n_v: int, peel_rows: int,
                   impl: str = "shardmap"):
    """Cost one production-scale CD step on ``mesh`` (meta positions):
    ``_CDShards`` pieces of an (n_u, n_v) 0/1 matrix, traced under
    ``utils.op_cost.OpCost``.  Returns the ``op_cost.Cost`` (the record
    the reference's ``Lowered`` gives its dry run).

    ``impl`` ``"shardmap"`` / ``"gspmd"``: one ``_CDShards.sweep`` of a
    ``peel_rows``-wide gathered peel set (the reference's two schedules
    are one here).  ``"fused"``: one sweep of the range loop's body (the
    peel set, the buffer of ``peel_rows`` rows, the sweep), the buffer
    full: the loop's read of the set's size is a host read, which meta
    tensors cannot answer.  Arguments per position are the reference's
    (``A`` over (dp, model), the vectors over dp, the peel rows and the
    scalars replicated), with ``A``'s piece in f32.

    The sweep's chunk loop (``peel_rows / 16384`` equal chunks, the
    engine's default chunk) is traced
    at one and two chunks and extrapolated to its trip count (the cost
    is affine in it; the peak is the second chunk's, which each later
    chunk repeats, plus the longer peel-row arguments); ``cost.depths``
    records that."""
    from ..utils.op_cost import Cost

    chunk = _CHUNK
    n_chunks = -(-peel_rows // chunk)
    if n_chunks <= 2 or peel_rows % chunk:
        return _cost_cd_sweep(mesh, n_u, n_v, peel_rows, impl, chunk)
    costs = [_cost_cd_sweep(mesh, n_u, n_v, k * chunk, impl, chunk)
             for k in (1, 2)]
    out = Cost.combine(costs, [2 - n_chunks, n_chunks - 1], depths={
        "chunks": {"traced": [1, 2], "config": n_chunks}})
    out.peak = costs[1].peak + (out.args - costs[1].args)
    return out


def _cost_cd_sweep(mesh, n_u, n_v, peel_rows, impl, chunk):
    """``lower_cd_sweep``'s one trace, the chunk loop whole."""
    from ..utils.op_cost import OpCost

    if impl not in _IMPLS + ("fused",):
        raise ValueError(f"impl {impl!r}: one of {_IMPLS + ('fused',)}")
    mesh = _meta_mesh(mesh)
    sh = _CDShards(mesh, torch.empty((n_u, n_v), dtype=_F32, device=_META))
    sup = sh.split(torch.empty(n_u, dtype=_F32, device=_META), _F32)
    alv = sh.split(torch.empty(n_u, dtype=torch.bool, device=_META),
                   torch.bool)
    dp = sh.dp if len(sh.dp) > 1 else (sh.dp[0] if sh.dp else None)
    tp = "model" if "model" in mesh.shape else None
    piece = {
        "a": _piece_bytes(mesh, (dp, tp), (n_u, n_v), _F32),
        "vec": _piece_bytes(mesh, (dp,), (n_u,), _F32),
        "mask": _piece_bytes(mesh, (dp,), (n_u,), torch.bool),
        "ids": _piece_bytes(mesh, (dp,), (n_u,), torch.int32),
    }
    held = []
    for d in range(sh.n_dp):
        p0 = sh.pos[d][0]
        held += [(sup[d], piece["vec"], p0), (alv[d], piece["mask"], p0)]
        for m in range(sh.n_tp):
            held += [(sh.a[d][m], piece["a"], sh.pos[d][m]),
                     (sh.ids[d][m], piece["ids"], sh.pos[d][m])]
    # A, support, alive, ids and the scalars lo (and hi, fused)
    args = piece["a"] + piece["vec"] + piece["mask"] + piece["ids"] + 4
    with OpCost(mesh.size) as oc:
        if impl == "fused":
            oc.add_arguments(held)
            args += 4
            peel = _peel_mask(sh, sup, alv, 1.0)
            peel.sum()
            rows, valid = _peel_rows(
                peel, peel_rows, torch.arange(peel_rows, device=_META))
        else:
            rows = torch.empty(peel_rows, dtype=torch.int32, device=_META)
            valid = torch.empty(peel_rows, dtype=_F32, device=_META)
            oc.add_arguments(held + [(rows, 4 * peel_rows),
                                     (valid, 4 * peel_rows)])
            args += 8 * peel_rows
        sh.sweep(sup, alv, rows, valid, 0.0, chunk)
    cost = oc.cost
    cost.args = args
    cost.outputs = piece["vec"] + piece["mask"]
    return cost


def lower_fd_stack(mesh, *, n_subsets: int, rows: int, cols: int):
    """Cost one position's FD stack on ``mesh`` (meta positions): its
    ``n_subsets / mesh.size`` members through ``fd_stack_step`` (kernel 3,
    then the sequential peel's ``rows`` steps), traced under
    ``utils.op_cost.OpCost`` and booked to every position, since every
    position holds the same shape.  The subsets are independent: no
    collective.  Returns the ``op_cost.Cost``."""
    from ..utils.op_cost import ALL, OpCost

    mesh = _meta_mesh(mesh)
    if n_subsets % mesh.size:
        raise ValueError(f"{n_subsets} subsets do not split over "
                         f"{mesh.size} positions")
    g = n_subsets // mesh.size
    a = torch.empty((g, rows, cols), dtype=_F32, device=_META)
    sup0 = torch.empty((g, rows), dtype=_F32, device=_META)
    n_members = torch.empty(g, dtype=torch.int32, device=_META)
    lo = torch.empty(g, dtype=_F32, device=_META)
    held = [(t, t.numel() * t.element_size())
            for t in (a, sup0, n_members, lo)]
    with OpCost(mesh.size, unmarked=ALL) as oc:
        oc.add_arguments(held)
        theta = fd_stack_step(a, sup0, n_members, lo)
    cost = oc.cost
    cost.args = sum(n for _, n in held)
    cost.outputs = theta.numel() * theta.element_size()
    return cost
