"""AdamW with gradient clipping, schedules and int8 gradient compression
(port of ``repro.train.optimizer``).

The arithmetic is the reference's, in the order of its ``upd``: float32
math, the gradient scaled by the clip factor of the PRE-clip global norm,
bias corrections, decoupled weight decay.  The update is IN PLACE and
chunked in rows of each leaf: it is elementwise, so chunking gives the
same numbers, and it keeps the temporaries to one chunk of each (the
reference's out-of-place update would hold several copies of the largest
table; at the two-tower model's full width that does not fit the card).
The step counter, learning rate and bias corrections stay 0-dim tensors
on the parameters' device, so a step never reads the card.

State dtypes are configurable (``AdamWConfig.state_dtype``, a torch
dtype); the math runs in float32 either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .tree import keystr, leaves_with_paths, map_leaves

__all__ = ["AdamWConfig", "lr_at", "adamw_init", "global_norm",
           "adamw_update", "compress_int8", "decompress_int8"]

Params = Any

# elements per chunk of the in-place update (16 MiB of float32)
_CHUNK_ELEMS = 1 << 22


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # "cosine" | "constant"


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        decay = 0.5 * (1.0 + torch.cos(math.pi * t))
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def adamw_init(params: Params, cfg: AdamWConfig) -> Dict[str, Any]:
    leaves = leaves_with_paths(params)
    dev = leaves[0][1].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    return {
        "m": map_leaves(zeros, params),
        "v": map_leaves(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a reduction
    per leaf: no leaf-sized temporary)."""
    leaves = [t for _, t in leaves_with_paths(tree)]
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32).square()
          for t in leaves]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


def _chunks(n_rows: int, row_elems: int):
    rows = max(_CHUNK_ELEMS // max(row_elems, 1), 1)
    for r0 in range(0, n_rows, rows):
        yield slice(r0, min(r0 + rows, n_rows))


@torch.no_grad()
def adamw_update(
    params: Params,
    grads,
    opt_state: Dict[str, Any],
    cfg: AdamWConfig,
) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` and the state's ``m``/``v``.

    ``grads`` has the params' leaves in their order: a tree of the
    params' structure, or a flat list; it is read, never written.
    Returns ``(params, state, {"grad_norm", "lr"})``: the same params and
    m/v objects, a new step counter, the pre-clip norm."""
    named = leaves_with_paths(params)
    g_list = [t for _, t in leaves_with_paths(grads)]
    if len(g_list) != len(named):
        raise ValueError(f"{len(g_list)} gradients for {len(named)} params")
    m_of = {keystr(p): t for p, t in leaves_with_paths(opt_state["m"])}
    v_of = {keystr(p): t for p, t in leaves_with_paths(opt_state["v"])}

    step = opt_state["step"] + 1
    gnorm = global_norm(g_list)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, sf)
    bc2 = 1.0 - torch.pow(b2, sf)
    f32 = torch.float32

    for (path, p), g in zip(named, g_list):
        key = keystr(path)
        m, v = m_of[key], v_of[key]
        pd = p.data if isinstance(p, torch.nn.Parameter) else p
        # views (a non-contiguous leaf raises rather than update a copy)
        rows = pd.shape[0] if pd.dim() else 1
        pv, mv, vv = (x.view(rows, -1) for x in (pd, m, v))
        gv = g.reshape(rows, -1)
        for r in _chunks(pv.shape[0], pv.shape[1]):
            pc, mc, vc = pv[r], mv[r], vv[r]
            g32 = gv[r].to(f32) * scale
            m32 = mc if mc.dtype == f32 else mc.to(f32)
            v32 = vc if vc.dtype == f32 else vc.to(f32)
            m32.mul_(b1).add_(g32, alpha=1 - b1)          # b1 m + (1-b1) g
            v32.mul_(b2).addcmul_(g32, g32, value=1 - b2)  # b2 v + (1-b2) g g
            mh = m32 / bc1
            denom = (v32 / bc2).sqrt_().add_(cfg.eps)     # sqrt(vh) + eps
            delta = mh.div_(denom)
            p32 = pc if pc.dtype == f32 else pc.to(f32)
            delta.add_(p32, alpha=cfg.weight_decay)       # + wd p
            p32.sub_(delta.mul_(lr))                      # p - lr delta
            for dst, src in ((pc, p32), (mc, m32), (vc, v32)):
                if src is not dst:
                    dst.copy_(src)
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------- #
# int8 gradient compression with error feedback
# --------------------------------------------------------------------- #
def compress_int8(g: torch.Tensor, err: torch.Tensor):
    """Symmetric per-tensor int8 quantization; returns (q, scale, new_err).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    g32 = g.to(torch.float32) + err
    amax = torch.clamp(g32.abs().max(), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, g32 - deq


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
