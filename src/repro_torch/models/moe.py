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

``moe_forward_sharded`` (the expert exchange over a mesh's ``model``
axis) is the sharded LM's (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..launch.sharding import current_mesh, shard_act
from .layers import (SwiGLU, _param, dense_init, draw, init_device,
                     init_swiglu, swiglu)

__all__ = ["MoE", "init_moe", "route", "topk_indices", "moe_forward"]


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
    if current_mesh() is not None:
        raise NotImplementedError(
            "moe_forward_sharded (the expert exchange over a mesh) is not "
            "ported yet; run the MoE without a mesh context")
    b, s, d = x.shape
    n_e = p.router.shape[-1]
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
