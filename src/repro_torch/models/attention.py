"""Attention: GQA and MLA (DeepSeek latent attention), train + decode
(port of ``repro.models.attention``).

* ``flash_attention`` — blockwise causal attention with online softmax: a
  Python loop over KV blocks inside one over Q blocks, torch ops on both
  the CPU and the card.  The S x S score matrix never materializes.  A KV
  block wholly above a Q block's causal diagonal is skipped: there its
  probabilities are exactly 0 and its correction exactly 1, so skipping
  it changes no bit of the reference's recurrence.
* ``gqa_*`` — grouped-query attention (Command-R / Minitron / DeepSeek-67B).
* ``mla_*`` — multi-head latent attention (DeepSeek-V2/V3).  Training and
  prefill use the naive (decompressed) form; decode uses the
  weight-absorbed form against the compressed (c_kv, k_rope) cache.

Shapes: activations (B, S, D).  Caches are dicts of tensors with a
``len``, a host int (so a decode step reads nothing back from the
card).  The decode functions write the
new position into the cache tensors IN PLACE and return the same tensors
(the reference's ``dynamic_update_slice`` returns new ones): the cache is
preallocated once and never copied.

Params are ``nn.Module``s under the reference's names (``wq``, ``wkv_a``,
``kv_norm.scale``, ...); the functions read them by attribute, so a
``layers.layer_at`` view of one layer of a stacked module works too.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..launch.sharding import shard_act
from ..utils import op_cost
from .layers import _param, apply_rope, dense_init, init_rmsnorm, rmsnorm

__all__ = ["flash_attention", "decode_attention", "GQA", "init_gqa",
           "gqa_forward", "gqa_decode", "MLA", "init_mla", "mla_forward",
           "mla_decode"]

_NEG_INF = -1e30


# --------------------------------------------------------------------- #
# blockwise (flash) attention
# --------------------------------------------------------------------- #
def flash_attention(
    q: torch.Tensor,          # (B, H, Sq, Dh)
    k: torch.Tensor,          # (B, Hkv, Sk, Dh)
    v: torch.Tensor,          # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax blockwise attention (FlashAttention recurrence).

    Supports Hkv < H (GQA) by head-group broadcasting.  q_offset shifts
    query positions for causal masking (prefill continuation).  Scores
    and the softmax statistics are float32; the accumulator and the
    output stay in v's dtype, as in the reference.  Every call of the
    same shapes costs the same: a cost mode traces the blocked loop once
    (``utils.op_cost.repeat_call``)."""
    opts = dict(causal=causal, q_block=q_block, kv_block=kv_block,
                q_offset=q_offset)
    return op_cost.repeat_call(
        lambda q_, k_, v_: (_flash_attention(q_, k_, v_, **opts),),
        [q, k, v], ("flash_attention", tuple(opts.items())))[0]


def _flash_attention(q, k, v, *, causal, q_block, kv_block, q_offset):
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // hkv
    scale = 1.0 / math.sqrt(dh)

    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    nq, nk = sq // q_block, sk // kv_block
    assert sq % q_block == 0 and sk % kv_block == 0

    qg = q.reshape(b, hkv, rep, sq, dh)
    k_pos_all = torch.arange(sk, device=q.device)
    outs = []
    for i in range(nq):
        qb = qg[:, :, :, i * q_block:(i + 1) * q_block]
        q_pos = q_offset + torch.arange(i * q_block, (i + 1) * q_block,
                                        device=q.device)
        q_last = q_offset + (i + 1) * q_block - 1
        m = torch.full((b, hkv, rep, q_block), _NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, rep, q_block), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, rep, q_block, dv), dtype=v.dtype,
                          device=q.device)
        for j in range(nk):
            if causal and j * kv_block > q_last:
                break           # every later block is fully masked
            kb = k[:, :, j * kv_block:(j + 1) * kv_block]
            vb = v[:, :, j * kv_block:(j + 1) * kv_block]
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb, kb) * scale
            s = s.to(torch.float32)
            if causal:
                k_pos = k_pos_all[j * kv_block:(j + 1) * kv_block]
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype), vb)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        inv_l = (1.0 / torch.clamp(l, min=1e-30)).to(acc.dtype)
        outs.append(acc * inv_l[..., None])
    out = torch.cat(outs, dim=3)            # (B, Hkv, rep, Sq, Dv)
    return out.reshape(b, h, sq, dv)


def _len_mask(s: int, cache_len: int, device) -> torch.Tensor:
    """(s,) bool: positions below the host int ``cache_len``."""
    return torch.arange(s, device=device) < cache_len


def decode_attention(
    q: torch.Tensor,          # (B, H, 1, Dh)
    k_cache: torch.Tensor,    # (B, Hkv, S, Dh)
    v_cache: torch.Tensor,    # (B, Hkv, S, Dv)
    cache_len: int,           # host int
) -> torch.Tensor:
    """Single-token attention against a (possibly padded) KV cache."""
    b, h, _, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    qr = q.reshape(b, hkv, rep, dh)
    scores = torch.einsum("bgrd,bgsd->bgrs", qr, k_cache) / math.sqrt(dh)
    mask = _len_mask(s, cache_len, q.device)
    scores = torch.where(mask, scores.to(torch.float32), _NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bgrs,bgsd->bgrd", p, v_cache)
    return out.reshape(b, h, 1, -1)


def _positions(b: int, pos: int, device) -> torch.Tensor:
    """(B, 1, 1) decode position from the host int ``pos``."""
    return torch.full((b, 1, 1), pos, dtype=torch.int32, device=device)


def _write_at(cache: torch.Tensor, new: torch.Tensor, pos: int, dim: int):
    """Write ``new`` (size 1 along ``dim``) into ``cache`` at the host int
    ``pos``, in place."""
    cache.narrow(dim, pos, 1).copy_(new)
    return cache


# --------------------------------------------------------------------- #
# GQA
# --------------------------------------------------------------------- #
class GQA(nn.Module):
    """``wq`` (D, H*Dh), ``wk``/``wv`` (D, Hkv*Dh), ``wo`` (H*Dh, D)."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (_param(wq), _param(wk),
                                              _param(wv), _param(wo))


def init_gqa(generator, d: int, n_heads: int, n_kv: int, d_head: int,
             dtype=torch.float32, *, device=None, n_stack=None) -> GQA:
    kw = dict(device=device, n_stack=n_stack)
    return GQA(dense_init(generator, d, n_heads * d_head, dtype, **kw),
               dense_init(generator, d, n_kv * d_head, dtype, **kw),
               dense_init(generator, d, n_kv * d_head, dtype, **kw),
               dense_init(generator, n_heads * d_head, d, dtype, **kw))


def gqa_forward(
    p,
    x: torch.Tensor,                     # (B, S, D)
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    positions: Optional[torch.Tensor] = None,
    rope_theta: float = 10000.0,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = (x @ p.wq).reshape(b, s, n_heads, d_head)
    k = (x @ p.wk).reshape(b, s, n_kv, d_head)
    v = (x @ p.wv).reshape(b, s, n_kv, d_head)
    q = apply_rope(q.transpose(1, 2), positions[:, None], rope_theta)
    k = apply_rope(k.transpose(1, 2), positions[:, None], rope_theta)
    v = v.transpose(1, 2)
    # Megatron layout: expand KV to full heads (as the reference)
    rep = n_heads // n_kv
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    q = shard_act(q, ("batch", "tp", None, None))
    k = shard_act(k, ("batch", "tp", None, None))
    v = shard_act(v, ("batch", "tp", None, None))
    o = flash_attention(q, k, v, causal=True, q_block=q_block,
                        kv_block=kv_block)
    o = shard_act(o, ("batch", "tp", None, None))
    o = o.transpose(1, 2).reshape(b, s, n_heads * d_head)
    return o @ p.wo


def gqa_decode(
    p,
    x: torch.Tensor,                     # (B, 1, D)
    cache: Dict[str, torch.Tensor],      # {"k": (B,Hkv,S,Dh), "v": ..., "len"}
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    rope_theta: float = 10000.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b = x.shape[0]
    pos = cache["len"]
    q = (x @ p.wq).reshape(b, 1, n_heads, d_head).transpose(1, 2)
    k = (x @ p.wk).reshape(b, 1, n_kv, d_head).transpose(1, 2)
    v = (x @ p.wv).reshape(b, 1, n_kv, d_head).transpose(1, 2)
    posv = _positions(b, pos, x.device)
    q = apply_rope(q, posv, rope_theta)
    k = apply_rope(k, posv, rope_theta)
    k_cache = _write_at(cache["k"], k, pos, 2)
    v_cache = _write_at(cache["v"], v, pos, 2)
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    o = o.transpose(1, 2).reshape(b, 1, n_heads * d_head)
    new_cache = {"k": k_cache, "v": v_cache, "len": pos + 1}
    return o @ p.wo, new_cache


# --------------------------------------------------------------------- #
# MLA (DeepSeek-V2/V3)
# --------------------------------------------------------------------- #
class MLA(nn.Module):
    """``wkv_a`` (D, kv_lora + d_rope), ``kv_norm``, ``wkv_b`` (kv_lora,
    H (d_nope + d_v)), ``wo`` (H d_v, D); with q_lora > 0 ``wq_a`` (D,
    q_lora), ``q_norm``, ``wq_b`` (q_lora, H (d_nope + d_rope)), else
    ``wq`` (D, H (d_nope + d_rope))."""

    def __init__(self, wkv_a, kv_norm, wkv_b, wo, *, wq=None, wq_a=None,
                 q_norm=None, wq_b=None):
        super().__init__()
        self.wkv_a = _param(wkv_a)
        self.kv_norm = kv_norm
        self.wkv_b = _param(wkv_b)
        self.wo = _param(wo)
        if wq_a is not None:
            self.wq_a = _param(wq_a)
            self.q_norm = q_norm
            self.wq_b = _param(wq_b)
        else:
            self.wq = _param(wq)


def init_mla(generator, d: int, n_heads: int, q_lora: int, kv_lora: int,
             d_nope: int, d_rope: int, d_v: int, dtype=torch.float32, *,
             device=None, n_stack=None) -> MLA:
    kw = dict(device=device, n_stack=n_stack)
    qk = n_heads * (d_nope + d_rope)
    p = dict(
        wkv_a=dense_init(generator, d, kv_lora + d_rope, dtype, **kw),
        kv_norm=init_rmsnorm(kv_lora, dtype, **kw),
        wkv_b=dense_init(generator, kv_lora, n_heads * (d_nope + d_v),
                         dtype, **kw),
        wo=dense_init(generator, n_heads * d_v, d, dtype, **kw),
    )
    if q_lora > 0:
        p.update(wq_a=dense_init(generator, d, q_lora, dtype, **kw),
                 q_norm=init_rmsnorm(q_lora, dtype, **kw),
                 wq_b=dense_init(generator, q_lora, qk, dtype, **kw))
    else:
        p.update(wq=dense_init(generator, d, qk, dtype, **kw))
    return MLA(**p)


def _mla_q(p, x, n_heads, d_nope, d_rope):
    b, s, _ = x.shape
    if hasattr(p, "wq_a"):
        cq = rmsnorm(p.q_norm, x @ p.wq_a)
        q = cq @ p.wq_b
    else:
        q = x @ p.wq
    q = q.reshape(b, s, n_heads, d_nope + d_rope).transpose(1, 2)
    return q[..., :d_nope], q[..., d_nope:]


def mla_forward(
    p,
    x: torch.Tensor,
    *,
    n_heads: int,
    kv_lora: int,
    d_nope: int,
    d_rope: int,
    d_v: int,
    positions: Optional[torch.Tensor] = None,
    rope_theta: float = 10000.0,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Naive (decompressed) MLA for training / prefill."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, n_heads, d_nope, d_rope)
    q_rope = apply_rope(q_rope, positions[:, None], rope_theta)

    kv = x @ p.wkv_a
    c_kv, k_rope = kv[..., :kv_lora], kv[..., kv_lora:]
    c_kv = rmsnorm(p.kv_norm, c_kv)
    k_rope = apply_rope(k_rope[:, None], positions[:, None], rope_theta)
    kvu = (c_kv @ p.wkv_b).reshape(b, s, n_heads, d_nope + d_v)
    k_nope = kvu[..., :d_nope].transpose(1, 2)
    v = kvu[..., d_nope:].transpose(1, 2)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, n_heads, s, d_rope)], dim=-1)
    q = shard_act(q, ("batch", "tp", None, None))
    k = shard_act(k, ("batch", "tp", None, None))
    v = shard_act(v, ("batch", "tp", None, None))
    o = flash_attention(q, k, v, causal=True, q_block=q_block,
                        kv_block=kv_block)
    o = shard_act(o, ("batch", "tp", None, None))
    o = o.transpose(1, 2).reshape(b, s, n_heads * d_v)
    return o @ p.wo


def mla_decode(
    p,
    x: torch.Tensor,                      # (B, 1, D)
    cache: Dict[str, torch.Tensor],       # {"c_kv": (B,S,kv_lora), "k_rope": (B,S,d_rope), "len"}
    *,
    n_heads: int,
    kv_lora: int,
    d_nope: int,
    d_rope: int,
    d_v: int,
    rope_theta: float = 10000.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weight-absorbed MLA decode on the compressed cache.

    scores = q_nope^T W_uk c_t  +  q_rope^T k_rope_t
    out    = W_o W_uv (sum_t p_t c_t)

    in the reference's order, with its float32 upcast of the scores."""
    b = x.shape[0]
    pos = cache["len"]
    q_nope, q_rope = _mla_q(p, x, n_heads, d_nope, d_rope)   # (B,H,1,*)
    posv = _positions(b, pos, x.device)
    q_rope = apply_rope(q_rope, posv, rope_theta)

    kv = x @ p.wkv_a                                          # (B,1,kv_lora+d_rope)
    c_new = rmsnorm(p.kv_norm, kv[..., :kv_lora])
    kr_new = apply_rope(kv[:, None, :, kv_lora:], posv, rope_theta)[:, 0]

    c_cache = _write_at(cache["c_kv"], c_new, pos, 1)
    r_cache = _write_at(cache["k_rope"], kr_new, pos, 1)

    # absorb W_uk into q: (B,H,1,d_nope) @ (H, d_nope, kv_lora)
    wkv_b = p.wkv_b.reshape(kv_lora, n_heads, d_nope + d_v)
    w_uk = wkv_b[..., :d_nope].permute(1, 2, 0)              # (H, d_nope, kv_lora)
    w_uv = wkv_b[..., d_nope:].permute(1, 0, 2)              # (H, kv_lora, d_v)
    q_abs = torch.einsum("bhqd,hdc->bhqc", q_nope, w_uk)     # (B,H,1,kv_lora)

    s_max = c_cache.shape[1]
    scores = torch.einsum("bhqc,bsc->bhqs", q_abs, c_cache)
    scores = scores + torch.einsum("bhqr,bsr->bhqs", q_rope, r_cache)
    scores = scores.to(torch.float32) / math.sqrt(d_nope + d_rope)
    mask = _len_mask(s_max, pos + 1, x.device)
    scores = torch.where(mask, scores, _NEG_INF)
    prob = torch.softmax(scores, dim=-1).to(c_cache.dtype)
    ctx = torch.einsum("bhqs,bsc->bhqc", prob, c_cache)      # compressed ctx
    o = torch.einsum("bhqc,hcv->bhqv", ctx, w_uv)            # (B,H,1,d_v)
    o = o.transpose(1, 2).reshape(b, 1, n_heads * d_v)
    new_cache = {"c_kv": c_cache, "k_rope": r_cache, "len": pos + 1}
    return o @ p.wo, new_cache
