"""Generic train-step factory: loss fn -> ``(state, batch) -> (state,
metrics)`` (port of ``repro.train.train_step``).

The gradients come from ``torch.autograd`` over the parameters' leaves
(an ``nn.Module``'s parameters or a tree of tensors), and the AdamW update
(``optimizer.adamw_update``) runs in place on the state's params and
moments.  The gradients are dropped once the update has read them, so a
step holds them only between the backward and the update.

Options (as the reference's):
  * ``microbatches > 1``: the step loops over equal chunks of the batch
    (its leading dim), sums their gradients in float32 and divides by
    ``microbatches``; the metrics are the mean over the chunks;
  * ``compress_grads``: each gradient goes through int8 quantization with
    zero error (``compress_int8`` then ``decompress_int8``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        compress_int8, decompress_int8)
from .tree import leaves_with_paths

__all__ = ["init_train_state", "make_train_step"]

TrainState = Dict[str, Any]


def init_train_state(params, opt_cfg: AdamWConfig) -> TrainState:
    """The state owns ``params`` (no copy): the step updates them in
    place."""
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def _grads(loss_fn, params, leaves, batch):
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g
          for p, g in zip(leaves, gs)]
    return loss.detach(), {k: torch.as_tensor(v).detach()
                           for k, v in dict(metrics).items()}, gs


def make_train_step(
    loss_fn: Callable,                 # (params, batch) -> (loss, metrics)
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    compress_grads: bool = False,
) -> Callable[[TrainState, Any], Tuple[TrainState, Dict[str, torch.Tensor]]]:

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state["params"]
        leaves = [t for _, t in leaves_with_paths(params)]
        for t in leaves:
            if not t.requires_grad:
                t.requires_grad_(True)
        if microbatches > 1:
            mbs = {k: x.reshape(microbatches, -1, *x.shape[1:])
                   for k, x in batch.items()}
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            losses, metricss = [], []
            for i in range(microbatches):
                loss, mets, gs = _grads(loss_fn, params, leaves,
                                        {k: x[i] for k, x in mbs.items()})
                for acc, g in zip(gsum, gs):
                    acc.add_(g)
                del gs
                losses.append(loss)
                metricss.append(mets)
            grads = [g.div_(microbatches) for g in gsum]
            metrics = {k: torch.stack([m[k] for m in metricss]).mean()
                       for k in metricss[0]}
            metrics["loss"] = torch.stack(losses).mean()
        else:
            loss, metrics, grads = _grads(loss_fn, params, leaves, batch)
            metrics["loss"] = loss

        if compress_grads:
            def c(g):
                q, s, _ = compress_int8(
                    g, torch.zeros_like(g, dtype=torch.float32))
                return decompress_int8(q, s).to(g.dtype)

            grads = [c(g) for g in grads]

        _, new_opt, opt_metrics = adamw_update(params, grads, state["opt"],
                                               opt_cfg)
        del grads
        metrics.update(opt_metrics)
        return {"params": params, "opt": new_opt}, metrics

    return step
