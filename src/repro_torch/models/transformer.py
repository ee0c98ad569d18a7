"""LM transformer assembly: dense-GQA and MoE-MLA stacks (port of
``repro.models.transformer``).

* homogeneous layers are stacked along a leading L axis, as the
  reference's ``vmap``'d init builds them; where the reference drives the
  stack with ``lax.scan``, the port loops over L in Python over the views
  ``leaf[l]`` (``layers.layer_at``: no copy).  With ``cfg.remat`` each
  layer is rematerialized (``layers.remat``, the reference's
  ``jax.checkpoint(body)``) while grad is enabled: the train step keeps
  only the residual stream between layers; the serving path, which runs
  without gradients, calls the layers plainly;
* the first ``n_dense_layers`` of the MoE archs (DeepSeek-V2/V3 use dense
  FFNs there) are a separate homogeneous prefix stack;
* DeepSeek-V3's MTP head (multi-token prediction) is one extra
  transformer layer predicting token t+2, sharing the embedding and
  output head (arXiv:2412.19437 section 2.2);
* the decode step consumes per-layer caches stacked along L and writes
  each layer's new position into them in place (``len`` is a host int,
  so the loop reads nothing back from the card).

Entry points without a device (``init_lm`` with no generator, ``init_cache``)
build on the card and raise without one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..launch.sharding import shard_act
from . import attention as attn
from . import moe as moe_lib
from .layers import (RMSNorm, _param, draw, embed_init, init_device,
                     init_rmsnorm, init_swiglu, layer_at, remat, rmsnorm,
                     softmax_cross_entropy, swiglu)

__all__ = ["LMConfig", "Layer", "MTP", "LM", "init_lm", "lm_hidden",
           "lm_logits", "lm_loss", "init_cache", "lm_decode_step",
           "lm_prefill"]


# --------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    attn_kind: str = "gqa"            # "gqa" | "mla"
    # MLA dims (DeepSeek-V2/V3)
    q_lora: int = 0
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    # MoE
    moe: bool = False
    moe_group_size: int = 256        # seq-local dispatch group (aligns with SP)
    n_routed: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_ff_moe: int = 0
    n_dense_layers: int = 0
    router_mode: str = "softmax_topk"  # "softmax_topk" | "sigmoid_bias"
    capacity_factor: float = 1.25
    # MTP
    mtp: bool = False
    mtp_weight: float = 0.3
    # misc
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    param_dtype: Any = torch.float32
    remat: bool = True
    q_block: int = 512
    kv_block: int = 1024

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - self.n_dense_layers


# --------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------- #
class Layer(nn.Module):
    """One pre-norm block (or a stack of them, every leaf with a leading
    L axis): ``attn_norm``, ``attn``, ``ffn_norm`` and ``mlp`` or
    ``moe``."""

    def __init__(self, attn_norm: RMSNorm, attn_p: nn.Module,
                 ffn_norm: RMSNorm, ffn: nn.Module, use_moe: bool):
        super().__init__()
        self.attn_norm = attn_norm
        self.attn = attn_p
        self.ffn_norm = ffn_norm
        if use_moe:
            self.moe = ffn
        else:
            self.mlp = ffn


class MTP(nn.Module):
    """DeepSeek-V3's multi-token-prediction head."""

    def __init__(self, layer: Layer, proj, norm_h: RMSNorm, norm_e: RMSNorm):
        super().__init__()
        self.layer = layer
        self.proj = _param(proj)
        self.norm_h = norm_h
        self.norm_e = norm_e


class LM(nn.Module):
    """``embed``, ``final_norm``, ``lm_head`` (unless tied), the stacks
    ``dense_layers`` (MoE archs' dense prefix) and ``layers``, ``mtp``."""

    def __init__(self, embed, final_norm: RMSNorm, layers: Layer, *,
                 lm_head=None, dense_layers: Optional[Layer] = None,
                 mtp: Optional[MTP] = None):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = final_norm
        if lm_head is not None:
            self.lm_head = _param(lm_head)
        if dense_layers is not None:
            self.dense_layers = dense_layers
        self.layers = layers
        if mtp is not None:
            self.mtp = mtp


def _init_attn(generator, cfg: LMConfig, device, n_stack):
    kw = dict(device=device, n_stack=n_stack)
    if cfg.attn_kind == "mla":
        return attn.init_mla(
            generator, cfg.d_model, cfg.n_heads, cfg.q_lora, cfg.kv_lora,
            cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.param_dtype, **kw)
    return attn.init_gqa(
        generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
        cfg.param_dtype, **kw)


def _init_layer(generator, cfg: LMConfig, use_moe: bool, device,
                n_stack: Optional[int] = None) -> Layer:
    kw = dict(device=device, n_stack=n_stack)
    if use_moe:
        ffn = moe_lib.init_moe(generator, cfg.d_model, cfg.d_ff_moe,
                               cfg.n_routed, cfg.n_shared,
                               dtype=cfg.param_dtype, **kw)
    else:
        ffn = init_swiglu(generator, cfg.d_model, cfg.d_ff,
                          cfg.param_dtype, **kw)
    return Layer(init_rmsnorm(cfg.d_model, cfg.param_dtype, **kw),
                 _init_attn(generator, cfg, device, n_stack),
                 init_rmsnorm(cfg.d_model, cfg.param_dtype, **kw),
                 ffn, use_moe)


def init_lm(generator: Optional[torch.Generator], cfg: LMConfig, *,
            device=None) -> LM:
    """Params on ``device``, else the generator's device, else the card;
    ``device="meta"`` allocates nothing.  Every leaf is drawn in float32
    and cast to ``cfg.param_dtype`` in row chunks (``layers.draw``), so
    the peak stays near the parameter bytes."""
    dev = init_device(device, generator)
    dt = cfg.param_dtype
    embed = embed_init(generator, cfg.vocab, cfg.d_model, dt, device=dev)
    lm_head = (None if cfg.tie_embeddings else
               embed_init(generator, cfg.vocab, cfg.d_model, dt, device=dev))
    dense = (_init_layer(generator, cfg, False, dev, cfg.n_dense_layers)
             if cfg.n_dense_layers > 0 else None)
    layers = _init_layer(generator, cfg, cfg.moe, dev, cfg.n_scan_layers)
    mtp = None
    if cfg.mtp:
        mtp = MTP(_init_layer(generator, cfg, cfg.moe, dev),
                  draw((2 * cfg.d_model, cfg.d_model),
                       (2 * cfg.d_model) ** -0.5, dt, generator, dev),
                  init_rmsnorm(cfg.d_model, dt, device=dev),
                  init_rmsnorm(cfg.d_model, dt, device=dev))
    return LM(embed, init_rmsnorm(cfg.d_model, dt, device=dev), layers,
              lm_head=lm_head, dense_layers=dense, mtp=mtp)


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #
def _attn_fwd(p, x, cfg: LMConfig, positions=None):
    if cfg.attn_kind == "mla":
        return attn.mla_forward(
            p, x, n_heads=cfg.n_heads, kv_lora=cfg.kv_lora,
            d_nope=cfg.d_nope, d_rope=cfg.d_rope, d_v=cfg.d_v,
            positions=positions, rope_theta=cfg.rope_theta,
            q_block=cfg.q_block, kv_block=cfg.kv_block,
        )
    return attn.gqa_forward(
        p, x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
        positions=positions, rope_theta=cfg.rope_theta,
        q_block=cfg.q_block, kv_block=cfg.kv_block,
    )


def _layer_fwd(p, x, cfg: LMConfig, use_moe: bool):
    """Pre-norm residual block; returns (x, aux_loss)."""
    x = x + _attn_fwd(p.attn, rmsnorm(p.attn_norm, x), cfg)
    h = rmsnorm(p.ffn_norm, x)
    if use_moe:
        f, aux = moe_lib.moe_forward(
            p.moe, h, top_k=cfg.top_k, mode=cfg.router_mode,
            capacity_factor=cfg.capacity_factor,
            group_size=cfg.moe_group_size,
        )
    else:
        f = swiglu(p.mlp, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux


def _run_stack(stack: Layer, n: int, x, cfg: LMConfig, use_moe: bool):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(n):
        if cfg.remat:
            x, a = remat(_layer_fwd, layer_at(stack, l), x, cfg, use_moe)
        else:
            x, a = _layer_fwd(layer_at(stack, l), x, cfg, use_moe)
        x = shard_act(x, ("batch", "sp", None))
        aux = aux + a
    return x, aux


def lm_hidden(params: LM, tokens: torch.Tensor,
              cfg: LMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> final hidden (B, S, D), aux loss."""
    x = params.embed[tokens.long()]
    x = shard_act(x, ("batch", "sp", None))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_dense_layers > 0:
        x, aux = _run_stack(params.dense_layers, cfg.n_dense_layers, x, cfg,
                            False)
        aux_total = aux_total + aux
    x, aux = _run_stack(params.layers, cfg.n_scan_layers, x, cfg, cfg.moe)
    return x, aux_total + aux


def lm_logits(params: LM, h: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    h = rmsnorm(params.final_norm, h)
    head = params.embed if cfg.tie_embeddings else params.lm_head
    logits = h @ head.T
    return shard_act(logits, ("batch",) + (None,) * (logits.ndim - 2)
                     + ("tp",))


def lm_loss(params: LM, batch: Dict[str, torch.Tensor],
            cfg: LMConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ MTP next-next-token CE, + MoE aux)."""
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux = lm_hidden(params, tokens, cfg)
    logits = lm_logits(params, h, cfg)
    loss = softmax_cross_entropy(logits, labels)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp:
        # MTP: combine h_t with emb(token_{t+1}) to predict token_{t+2}
        # (= labels shifted by one).  Last position dropped.
        mtp = params.mtp
        emb_next = params.embed[labels.long()]                 # token_{t+1}
        hm = torch.cat([rmsnorm(mtp.norm_h, h),
                        rmsnorm(mtp.norm_e, emb_next)], dim=-1) @ mtp.proj
        hm, _ = _layer_fwd(mtp.layer, hm, cfg, cfg.moe)
        logits_mtp = lm_logits(params, hm[:, :-1], cfg)
        mtp_loss = softmax_cross_entropy(logits_mtp, labels[:, 1:])
        metrics["mtp_ce"] = mtp_loss
        loss = loss + cfg.mtp_weight * mtp_loss
    loss = loss + 0.003 * aux
    metrics["loss"] = loss
    return loss, metrics


# --------------------------------------------------------------------- #
# decode (serve) path
# --------------------------------------------------------------------- #
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> Dict[str, Any]:
    """Stacked per-layer caches (leading L axis), zeros on ``device``
    (None: the card); ``len`` a host int (0).  ``device="meta"`` gives
    the shapes only."""
    dev = init_device(device)
    dtype = dtype or cfg.param_dtype
    l = cfg.n_layers
    if cfg.attn_kind == "mla":
        return {
            "c_kv": torch.zeros((l, batch, max_len, cfg.kv_lora),
                                dtype=dtype, device=dev),
            "k_rope": torch.zeros((l, batch, max_len, cfg.d_rope),
                                  dtype=dtype, device=dev),
            "len": 0,
        }
    shape = (l, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "len": 0,
    }


def _layer_decode(p, x, layer_cache, pos, cfg: LMConfig, use_moe: bool):
    h = rmsnorm(p.attn_norm, x)
    if cfg.attn_kind == "mla":
        o, _ = attn.mla_decode(
            p.attn, h, dict(layer_cache, len=pos), n_heads=cfg.n_heads,
            kv_lora=cfg.kv_lora, d_nope=cfg.d_nope, d_rope=cfg.d_rope,
            d_v=cfg.d_v, rope_theta=cfg.rope_theta,
        )
    else:
        o, _ = attn.gqa_decode(
            p.attn, h, dict(layer_cache, len=pos), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta,
        )
    x = x + o
    x = shard_act(x, (None, None, "batch"))   # keep d aligned w/ FSDP axis
    hf = rmsnorm(p.ffn_norm, x)
    if use_moe:
        # decode uses no-drop dispatch (cap = T): serving must never drop
        # a token, and T is tiny at decode so the (E, T, d) tensor is cheap
        f, _ = moe_lib.moe_forward(
            p.moe, hf, top_k=cfg.top_k, mode=cfg.router_mode,
            capacity_factor=cfg.capacity_factor, no_drop=True,
            group_size=cfg.moe_group_size,
        )
    else:
        f = swiglu(p.mlp, hf)
    return x + f


@torch.no_grad()
def lm_decode_step(params: LM, cache: Dict[str, Any], token: torch.Tensor,
                   cfg: LMConfig):
    """One decode step.  token (B,) int -> (logits (B, V), cache).  The
    cache tensors are written in place at the host int ``cache["len"]``
    and returned with ``len + 1``."""
    x = params.embed[token.long()][:, None, :]                # (B, 1, D)
    x = shard_act(x, (None, None, "batch"))
    pos = cache["len"]
    arrays = {k: v for k, v in cache.items() if k != "len"}
    nd = cfg.n_dense_layers
    for l in range(cfg.n_layers):
        dense = l < nd
        lp = layer_at(params.dense_layers if dense else params.layers,
                      l if dense else l - nd)
        x = _layer_decode(lp, x, {k: v[l] for k, v in arrays.items()}, pos,
                          cfg, cfg.moe and not dense)
    logits = lm_logits(params, x, cfg)[:, 0]
    return logits, dict(arrays, len=pos + 1)


@torch.no_grad()
def lm_prefill(params: LM, tokens: torch.Tensor,
               cfg: LMConfig) -> torch.Tensor:
    """Prefill forward: next-token logits at the last position (B, V).

    Only the last position is projected to the vocab (serving never needs
    the (B, S, V) tensor)."""
    h, _ = lm_hidden(params, tokens, cfg)
    return lm_logits(params, h[:, -1:], cfg)[:, 0]
