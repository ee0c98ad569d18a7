"""Mixture-of-Experts FFN (DeepSeek-V2/V3 style: shared + routed experts;
port of ``repro.models.moe``, one device).

Dispatch is index-based (a stable argsort by expert id -> a
capacity-bounded scatter -> grouped expert matmuls -> a gather and a
scatter-add back), per (batch, sequence-block) token group as the
reference's double ``vmap``: here every group of the batch at once, each
with its own slots.

Routing variants:
  * "softmax_topk"  — V2: softmax over routed experts, top-k, the Switch
                      load-balance aux loss.
  * "sigmoid_bias"  — V3: sigmoid affinities + a per-expert bias added
                      for selection only (aux-loss-free balancing); gates
                      renormalized over the selected experts.

Ties are broken as the reference breaks them: the top-k is a stable
descending sort (``lax.top_k`` takes the lower index first; ``torch.topk``
on CUDA promises no order), and the dispatch sort is stable (it decides
which tokens a full expert drops).  The combine adds k pairs per token
with ``index_add_``, whose float order on the card is not fixed: the
outputs agree within tolerance, the routing and the drops exactly.

Under an active mesh with a ``model`` axis that the shapes divide,
``moe_forward`` takes ``moe_forward_sharded``: the reference's explicit
expert-parallel schedule, run position by position of the in-process
``DeviceMesh`` on each position's device, its ``all_to_all`` and
``all_gather`` done as copies and concatenations between the positions
(autograd flows through them).
"""
from __future__ import annotations

import types
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..launch.mesh import (NamedSharding, PartitionSpec, at_position,
                           axis_size, dp_axes, record_collective)
from ..launch.sharding import current_mesh, shard_act
from ..utils import op_cost
from .layers import (SwiGLU, _param, dense_init, draw, init_device,
                     init_swiglu, swiglu)

__all__ = ["MoE", "init_moe", "route", "topk_indices", "moe_forward",
           "moe_forward_sharded", "sharded_dispatch_applies"]


class MoE(nn.Module):
    """``router`` (d, E) and ``router_bias`` (E,) float32; routed experts
    stacked ``gate``/``up`` (E, d, f), ``down`` (E, f, d); optionally
    ``shared`` (a ``SwiGLU``)."""

    def __init__(self, router, router_bias, gate, up, down,
                 shared: Optional[SwiGLU] = None):
        super().__init__()
        self.router = _param(router)
        self.router_bias = _param(router_bias)
        self.gate, self.up, self.down = _param(gate), _param(up), _param(down)
        if shared is not None:
            self.shared = shared


def init_moe(generator, d: int, d_ff: int, n_routed: int, n_shared: int,
             d_ff_shared: Optional[int] = None, dtype=torch.float32, *,
             device=None, n_stack=None) -> MoE:
    """Routed experts stored stacked: (E, d, f) / (E, f, d); with
    ``n_stack`` every leaf gains a leading stack axis."""
    dev = init_device(device, generator)
    d_ff_shared = d_ff_shared or d_ff * max(n_shared, 1)
    kw = dict(device=dev, n_stack=n_stack)
    lead = () if n_stack is None else (n_stack,)
    shared = (init_swiglu(generator, d, d_ff_shared, dtype, **kw)
              if n_shared > 0 else None)
    return MoE(
        dense_init(generator, d, n_routed, torch.float32, **kw),
        torch.zeros(lead + (n_routed,), dtype=torch.float32, device=dev),
        draw((n_routed, d, d_ff), d ** -0.5, dtype, generator, **kw),
        draw((n_routed, d, d_ff), d ** -0.5, dtype, generator, **kw),
        draw((n_routed, d_ff, d), d_ff ** -0.5, dtype, generator, **kw),
        shared,
    )


def topk_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to the lower
    index (``lax.top_k``'s order): a stable descending sort."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k]


def route(p, x2d: torch.Tensor, *, top_k: int, mode: str = "softmax_topk"
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (expert_idx (..., T, k), gates (..., T, k), aux_loss (...)):
    the reference's ``route`` of each (T, d) token group, over any
    leading group axes."""
    logits = (x2d.to(torch.float32) @ p.router).to(torch.float32)
    n_e = logits.shape[-1]
    if mode == "sigmoid_bias":
        aff = torch.sigmoid(logits)
        sel_score = aff + p.router_bias
        idx = topk_indices(sel_score, top_k)
        gates = torch.gather(aff, -1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        aux = torch.zeros(logits.shape[:-2], dtype=torch.float32,
                          device=logits.device)
    else:
        probs = torch.softmax(logits, dim=-1)
        idx = topk_indices(probs, top_k)
        gates = torch.gather(probs, -1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        # Switch-style load-balance loss, per group
        me = probs.mean(dim=-2)
        flat = idx.reshape(*idx.shape[:-2], -1)
        ce = torch.zeros_like(me).scatter_add_(
            -1, flat, torch.ones(flat.shape, dtype=me.dtype,
                                 device=me.device)) / flat.shape[-1]
        aux = n_e * torch.sum(me * ce, dim=-1)
    return idx, gates.to(x2d.dtype), aux



def _dispatch(x: torch.Tensor, idx: torch.Tensor, gates: torch.Tensor,
              n_e: int, cap: int):
    """Dispatch every token group of ``x`` (G, t, d) to (G, E, cap, d) and
    return the combine metadata (the reference's ``_dispatch_group`` per
    group)."""
    n_g, t, d = x.shape
    k = idx.shape[-1]
    dev = x.device
    flat_e = idx.reshape(n_g, t * k)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    flat_gate = gates.reshape(n_g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = flat_tok[order]
    sgate = torch.gather(flat_gate, 1, order)

    ar = torch.arange(t * k, device=dev)
    seg_start = torch.ones_like(se, dtype=torch.bool)
    seg_start[:, 1:] = se[:, 1:] != se[:, :-1]
    start_of_seg = torch.cummax(torch.where(seg_start, ar, 0), dim=1)[0]
    pos_in_seg = ar - start_of_seg
    keep = pos_in_seg < cap
    slot = torch.where(keep, se * cap + pos_in_seg, n_e * cap)
    rows = n_e * cap + 1
    src = torch.gather(x, 1, stok[..., None].expand(-1, -1, d))
    src = src * keep[..., None].to(x.dtype)
    disp = torch.zeros((n_g * rows, d), dtype=x.dtype, device=dev)
    base = (torch.arange(n_g, device=dev) * rows)[:, None]
    disp.index_add_(0, (base + slot).reshape(-1), src.reshape(-1, d))
    disp = disp.reshape(n_g, rows, d)[:, :-1].reshape(n_g, n_e, cap, d)
    return disp, (slot, stok, sgate, keep)


def _combine(eout: torch.Tensor, meta, t: int) -> torch.Tensor:
    """(G, E, cap, d) expert outputs back to (G, t, d) tokens."""
    slot, stok, sgate, keep = meta
    n_g, n_e, cap, d = eout.shape
    eout2d = eout.reshape(n_g, n_e * cap, d)
    at = torch.where(keep, slot, 0)
    pair_out = torch.gather(eout2d, 1, at[..., None].expand(-1, -1, d)) * (
        sgate * keep.to(sgate.dtype))[..., None]
    out = torch.zeros((n_g * t, d), dtype=eout.dtype, device=eout.device)
    base = (torch.arange(n_g, device=eout.device) * t)[:, None]
    out.index_add_(0, (base + stok).reshape(-1),
                   pair_out.reshape(-1, d).to(eout.dtype))
    return out.reshape(n_g, t, d)


def sharded_dispatch_applies(mesh, b: int, s: int, n_e: int) -> bool:
    """The reference's condition for the explicit schedule: an active
    mesh with a ``model`` axis, the batch dividing the data axes, the
    sequence and the experts dividing ``model`` (so at ``model`` > 1 a
    decode step, s = 1, stays local)."""
    if mesh is None or "model" not in mesh.axis_names:
        return False
    n_model = mesh.shape["model"]
    n_dp = axis_size(mesh, dp_axes(mesh))
    return (b % n_dp == 0 and s % n_model == 0 and n_e % n_model == 0
            and s >= n_model)


def _gathered(pieces: List[torch.Tensor], dim: int) -> torch.Tensor:
    """The all_gather of pieces already on one device: their
    concatenation (one piece is itself: no copy)."""
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)


def moe_forward_sharded(
    p,
    x: torch.Tensor,                 # (B, S, d); batch over dp, seq over model
    *,
    top_k: int,
    capacity_factor: float,
    mode: str,
    no_drop: bool,
    mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's explicit expert-parallel MoE block over ``mesh``.

    Each position routes and dispatches ONLY its local (b_loc x s_loc)
    tokens, capacity ``t_loc * k / E * capacity_factor`` (at least 1;
    ``t_loc`` with ``no_drop``).  The expert exchange (the ``all_to_all``
    over ``model``) splits each position's (E, cap, d) dispatch on E
    between the positions of its data row, each receiving (E / n_model,
    n_model * cap, d) concatenated on the capacity axis, and the inverse
    brings the expert outputs back; each position's experts' weight
    slices are concatenated over the data positions (the FSDP
    ``all_gather``).  The shared experts' weights are put together whole
    once per device and applied token-locally; ``aux`` is the mean over
    every position.

    One process runs the positions in turn, data row by data row: each
    position's dispatch is copied into its row's receive buffers and
    dropped before the next position dispatches, and each expert
    position's received tokens are dropped once its outputs are sent
    back.  Every piece lives on its position's device (a view where that
    is ``x``'s device); the output is put together on ``x``'s device.
    Autograd flows through every copy.  Each position's work runs
    ``at_position`` of it, and the exchanges are recorded
    (``record_collective``) for the dry run."""
    dp = dp_axes(mesh)
    dp_spec = (dp if len(dp) > 1 else dp[0]) if dp else None
    n_model = mesh.shape["model"]
    n_dp = axis_size(mesh, dp)
    b, s, d = x.shape
    n_e = p.router.shape[-1]
    b_loc, s_loc = b // n_dp, s // n_model
    t_loc = b_loc * s_loc
    e_loc = n_e // n_model
    cap = t_loc if no_drop else max(
        int(t_loc * top_k / n_e * capacity_factor), 1)

    # the position holding data row r, model column j (of replicas along
    # any other axis, the first)
    at: dict = {}
    for k in range(mesh.size):
        c = mesh.coords(k)
        r = 0
        for a in dp:
            r = r * mesh.shape[a] + c[a]
        at.setdefault((r, c["model"]), k)

    def sharding(*spec):
        return NamedSharding(mesh, PartitionSpec(*spec))

    tokens = sharding(dp_spec, "model", None)
    x_pc = tokens.shard(x)
    gate_pc = sharding("model", dp_spec, None).shard(p.gate)
    up_pc = sharding("model", dp_spec, None).shard(p.up)
    down_pc = sharding("model", None, dp_spec).shard(p.down)
    shared = []
    if hasattr(p, "shared"):
        for w, spec in ((p.shared.gate, (dp_spec, "model")),
                        (p.shared.up, (dp_spec, "model")),
                        (p.shared.down, ("model", dp_spec))):
            shared.append((sharding(*spec), sharding(*spec).shard(w)))

    out_pc: List[Optional[torch.Tensor]] = [None] * mesh.size
    auxes = []
    shared_on: dict = {}     # the shared experts put together, per device
    for r in range(n_dp):
        row = [at[r, j] for j in range(n_model)]
        devs = [mesh.devices[k] for k in row]
        # 1. route and dispatch position by position, each dispatch split
        #    on E into the row's receive buffers (the all_to_all)
        recv = [torch.empty((e_loc, n_model * cap, d), dtype=x.dtype,
                            device=dv) for dv in devs]
        metas, x2s = [], []
        for j, k in enumerate(row):
            with at_position(k):
                x2 = x_pc[k].reshape(1, t_loc, d)
                rp = types.SimpleNamespace(
                    router=p.router.to(devs[j]),
                    router_bias=p.router_bias.to(devs[j]))
                idx, gates, aux = route(rp, x2, top_k=top_k, mode=mode)
                disp, meta = _dispatch(x2, idx, gates, n_e, cap)
                for jj in range(n_model):                # (1, E, cap, d)
                    recv[jj][:, j * cap:(j + 1) * cap].copy_(
                        disp[0, jj * e_loc:(jj + 1) * e_loc])
                del disp
                metas.append(meta)
                x2s.append(x2[0])
                auxes.append(aux[0].to(x.device))
        a2a_bytes = n_e * cap * d * x.element_size()
        record_collective("all-to-all", a2a_bytes, n_model, positions=row,
                          axes=("model",))
        # 2. each expert position in turn: gather its experts' weights
        #    over the data positions, run them, send the outputs back
        back: List[Optional[torch.Tensor]] = [None] * n_model
        for j in range(n_model):
            col = [at[rr, j] for rr in range(n_dp)]
            with at_position(row[j]):
                gate_w = _gathered([gate_pc[k].to(devs[j]) for k in col], 1)
                up_w = _gathered([up_pc[k].to(devs[j]) for k in col], 1)
                down_w = _gathered([down_pc[k].to(devs[j]) for k in col], 2)
                for name, w in (("gate", gate_w), ("up", up_w),
                                ("down", down_w)):
                    record_collective("all-gather",
                                      w.numel() * w.element_size(), n_dp,
                                      positions=[row[j]], axes=dp,
                                      param=f"moe/{name}")
                h, recv[j] = recv[j], None
                g = F.silu(torch.einsum("ecd,edf->ecf", h, gate_w))
                u = torch.einsum("ecd,edf->ecf", h, up_w)
                eout = torch.einsum("ecf,efd->ecd", g * u, down_w)
                del h, g, u, gate_w, up_w, down_w
                for jj in range(n_model):
                    if back[jj] is None:
                        back[jj] = torch.empty((n_e, cap, d),
                                               dtype=eout.dtype,
                                               device=devs[jj])
                    back[jj][j * e_loc:(j + 1) * e_loc].copy_(
                        eout[:, jj * cap:(jj + 1) * cap])
                del eout
        record_collective("all-to-all", a2a_bytes, n_model, positions=row,
                          axes=("model",))
        # 3. combine on each token position, plus the shared experts
        for j, k in enumerate(row):
            with at_position(k):
                out2 = _combine(back[j][None], metas[j], t_loc)[0]
                back[j] = None
                if shared:
                    if devs[j] not in shared_on:
                        shared_on[devs[j]] = types.SimpleNamespace(**{
                            name: spec.unshard(pc, devs[j])
                            for name, (spec, pc) in zip(
                                ("gate", "up", "down"), shared)})
                    out2 = out2 + swiglu(shared_on[devs[j]], x2s[j])
                out_pc[k] = out2.reshape(b_loc, s_loc, d)
    # replicas along any other axis stay None: unshard reads the first
    # position of each piece, the one that ran
    out = tokens.unshard(out_pc, x.device)
    return out, torch.stack(auxes).mean()


def moe_forward(
    p,
    x: torch.Tensor,                 # (B, S, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    mode: str = "softmax_topk",
    no_drop: bool = False,
    group_size: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, S, d), aux_loss): route, dispatch, the grouped
    SwiGLU experts and the combine per (batch, sequence-block) group of
    ``min(group_size, S)`` tokens; capacity per group ``group_size * k /
    E * capacity_factor`` (at least 1), or every token of the group with
    ``no_drop`` (the decode path: serving never drops a token)."""
    b, s, d = x.shape
    n_e = p.router.shape[-1]
    # distributed path: the explicit schedule when a mesh context is
    # active and the shapes divide it (training / prefill cells)
    mesh = current_mesh()
    if sharded_dispatch_applies(mesh, b, s, n_e):
        # the same cost for every layer: a cost mode traces it once
        names = ("router", "router_bias", "gate", "up", "down")
        leaves = [getattr(p, k) for k in names]
        if hasattr(p, "shared"):
            leaves += [p.shared.gate, p.shared.up, p.shared.down]

        def run(x_, *ws):
            q = types.SimpleNamespace(**dict(zip(names, ws)))
            if len(ws) > len(names):
                q.shared = types.SimpleNamespace(
                    **dict(zip(("gate", "up", "down"), ws[len(names):])))
            return moe_forward_sharded(
                q, x_, top_k=top_k, capacity_factor=capacity_factor,
                mode=mode, no_drop=no_drop, mesh=mesh)

        return op_cost.repeat_call(
            run, [x] + leaves,
            ("moe_forward_sharded", top_k, capacity_factor, mode, no_drop,
             tuple(mesh.shape.items()), mesh.devices))
    gs = min(group_size, s)
    n_g = s // gs
    assert n_g * gs == s, f"seq {s} not divisible by group {gs}"
    cap = gs if no_drop else max(int(gs * top_k / n_e * capacity_factor), 1)

    xg = x.reshape(b * n_g, gs, d)
    idx, gates, aux = route(p, xg, top_k=top_k, mode=mode)
    disp, meta = _dispatch(xg, idx, gates, n_e, cap)
    aux = aux.mean()
    expert_axes = ("batch", None, "expert", None, None)
    disp = shard_act(disp.reshape(b, n_g, n_e, cap, d), expert_axes)

    # grouped expert FFN (SwiGLU)
    g = F.silu(torch.einsum("bgecd,edf->bgecf", disp, p.gate))
    u = torch.einsum("bgecd,edf->bgecf", disp, p.up)
    eout = torch.einsum("bgecf,efd->bgecd", g * u, p.down)
    eout = shard_act(eout, expert_axes)

    out = _combine(eout.reshape(b * n_g, n_e, cap, d), meta, gs)
    out = shard_act(out.reshape(b, s, d), ("batch", "sp", None))
    if hasattr(p, "shared"):
        out = out + swiglu(p.shared, x)
    return out, aux
