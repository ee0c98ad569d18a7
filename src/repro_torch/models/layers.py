"""Shared neural building blocks (port of ``repro.models.layers``).

Conventions
-----------
* ``init_*`` functions take a ``torch.Generator`` + dims and return the
  parameters: a tensor, or an ``nn.Module`` holding them under the
  reference's names (``MLP.layers[i].w``/``.b``, ``RMSNorm.scale``, ...),
  so that carrying the reference's weights across is a rename
  (``convert.load_params``).  Tensors land on ``device``, else on the
  generator's device, else on the card (raising without one); on
  ``device="meta"`` nothing is allocated.
* ``apply``-style functions are plain functions of (params, inputs).
* compute dtype is the dtype of the activations passed in; norms and
  softmax always run in float32 and cast back.
* matmul weights are stored ``(d_in, d_out)``, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.engine.peel_loop import resolve_device

__all__ = ["draw", "dense_init", "layer_at", "embed_init", "RMSNorm",
           "init_rmsnorm", "rmsnorm", "LayerNorm", "init_layernorm", "layernorm", "SwiGLU",
           "init_swiglu", "swiglu", "Dense", "MLP", "init_mlp", "mlp",
           "matmul", "remat", "rope_freqs", "apply_rope",
           "softmax_cross_entropy"]


# --------------------------------------------------------------------- #
# initializers
# --------------------------------------------------------------------- #
def init_device(device=None, generator: Optional[torch.Generator] = None
                ) -> torch.device:
    """Where an initializer puts its tensors: ``device``, else the
    generator's device, else the card (``resolve_device``)."""
    if device is not None:
        return torch.device(device)
    if generator is not None:
        return generator.device
    return resolve_device(None)


def randn(shape, generator: Optional[torch.Generator], device=None
          ) -> torch.Tensor:
    """float32 normal draws from ``generator`` on ``init_device``; on
    ``device="meta"`` an unallocated tensor."""
    dev = init_device(device, generator)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=dev)


_DRAW_CHUNK = 1 << 26        # float32 elements drawn at a time


def draw(shape, scale: float, dtype, generator: Optional[torch.Generator],
         device=None, n_stack: Optional[int] = None) -> torch.Tensor:
    """``scale`` x float32 normal draws, cast to ``dtype``; with
    ``n_stack`` a leading stack axis of that many independent draws (the
    reference's ``vmap``'d init).  The draws go into the ``dtype`` tensor
    at most ``_DRAW_CHUNK`` float32 elements (whole rows) at a time, so a
    bfloat16 stack never has its float32 image on the device.  On
    ``device="meta"`` nothing is allocated."""
    dev = init_device(device, generator)
    shape = tuple(shape)
    full = shape if n_stack is None else (n_stack, *shape)
    out = torch.empty(full, dtype=dtype, device=dev)
    if dev.type == "meta":
        return out
    rows = out.reshape(-1, shape[-1]) if shape else out.reshape(-1, 1)
    step = max(_DRAW_CHUNK // max(rows.shape[1], 1), 1)
    for r0 in range(0, rows.shape[0], step):
        dst = rows[r0:r0 + step]
        dst.copy_(torch.randn(dst.shape, generator=generator,
                              dtype=torch.float32, device=dev).mul_(scale))
    return out


def dense_init(generator, d_in: int, d_out: int, dtype=torch.float32,
               scale=None, *, device=None, n_stack=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return draw((d_in, d_out), scale, dtype, generator, device, n_stack)


def embed_init(generator, vocab: int, d: int, dtype=torch.float32, *,
               device=None) -> torch.Tensor:
    return draw((vocab, d), 0.02, dtype, generator, device)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class layer_at:
    """Layer ``l`` of a stacked module (every leaf with a leading L axis,
    as the reference's ``vmap``'d init builds it): each parameter reads
    as the view ``leaf[l]`` (no copy), each submodule as its own
    ``layer_at``.  The model functions read params by attribute, so they
    take this view where they take a module."""

    __slots__ = ("_m", "_l")

    def __init__(self, module: nn.Module, l: int):
        self._m, self._l = module, l

    def __getattr__(self, name):
        v = getattr(self._m, name)
        if isinstance(v, torch.Tensor):
            return v[self._l]
        if isinstance(v, nn.Module):
            return layer_at(v, self._l)
        return v


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


def init_rmsnorm(d: int, dtype=torch.float32, *, device=None,
                 n_stack=None) -> RMSNorm:
    shape = (d,) if n_stack is None else (n_stack, d)
    return RMSNorm(torch.ones(shape, dtype=dtype, device=init_device(device)))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p.scale.to(torch.float32)
    return out.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)
        self.bias = _param(bias)


def init_layernorm(d: int, dtype=torch.float32, *, device=None
                   ) -> LayerNorm:
    dev = init_device(device)
    return LayerNorm(torch.ones((d,), dtype=dtype, device=dev),
                     torch.zeros((d,), dtype=dtype, device=dev))


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p.scale.to(torch.float32) + p.bias.to(torch.float32)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------- #
class SwiGLU(nn.Module):
    def __init__(self, gate, up, down):
        super().__init__()
        self.gate, self.up, self.down = _param(gate), _param(up), _param(down)


def init_swiglu(generator, d: int, f: int, dtype=torch.float32, *,
                device=None, n_stack=None) -> SwiGLU:
    kw = dict(device=device, n_stack=n_stack)
    return SwiGLU(dense_init(generator, d, f, dtype, **kw),
                  dense_init(generator, d, f, dtype, **kw),
                  dense_init(generator, f, d, dtype, **kw))


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p.gate)
    return (g * (x @ p.up)) @ p.down


class Dense(nn.Module):
    """One MLP layer: ``w`` (d_in, d_out) and, optionally, ``b``."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _param(w)
        if b is not None:
            self.b = _param(b)


class MLP(nn.Module):
    def __init__(self, layers: Sequence[Dense]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def init_mlp(generator, dims, dtype=torch.float32, bias: bool = True, *,
             device=None) -> MLP:
    """Plain MLP with ReLU between layers; dims = [in, h1, ..., out]."""
    layers = []
    for i in range(len(dims) - 1):
        w = dense_init(generator, dims[i], dims[i + 1], dtype, device=device)
        b = (torch.zeros((dims[i + 1],), dtype=dtype, device=w.device)
             if bias else None)
        layers.append(Dense(w, b))
    return MLP(layers)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (``jnp.matmul``'s rule:
    a bfloat16 carry against float32 weights is a float32 product); equal
    dtypes go straight through."""
    if x.dtype != w.dtype:
        dt = torch.result_type(x, w)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def mlp(p: MLP, x: torch.Tensor, act=torch.relu, final_act: bool = False):
    n = len(p.layers)
    for i, layer in enumerate(p.layers):
        x = matmul(x, layer.w)
        if hasattr(layer, "b"):
            x = x + layer.b
        if i < n - 1 or final_act:
            x = act(x)
    return x


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass (the
    reference's ``jax.checkpoint``) while grad is enabled; a plain call
    otherwise.  Non-reentrant checkpointing: the reentrant form does not
    work under the ``torch.autograd.grad`` of the train step."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------- #
# rotary position embedding
# --------------------------------------------------------------------- #
def rope_freqs(dim: int, max_pos: int, theta: float = 10000.0, *,
               device=None) -> torch.Tensor:
    """(max_pos, dim/2) complex-free cos/sin table base frequencies."""
    device = init_device(device)
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    return torch.outer(t, inv)  # (max_pos, dim/2)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, dim) with dim even; positions: (..., seq) int."""
    dim = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=x.device) / dim))
    ang = positions[..., None].to(torch.float32) * inv  # (..., seq, dim/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------- #
def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean token cross entropy; logits (..., V), labels (...) int; with
    ``mask`` the masked mean (at least one token's weight in the
    denominator).  The label log-prob is a gather (the reference's
    iota-compare sum has one nonzero term, so the two are equal)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
