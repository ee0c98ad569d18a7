"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``
(port of ``repro.launch.train``).

End-to-end loop over the substrate: the bundle's params drawn from a
seeded ``torch.Generator`` on the run's device, the synthetic data
pipeline, AdamW in place, checkpoint/restart through ``RestartManager``
(atomic + async), straggler monitoring, and optional gradient
compression / microbatch accumulation.  It runs on the card unless
``device`` says otherwise; the reduced configs also run on the CPU
(``--device cpu``).  Every arch of ``configs.ALL_ARCHS`` trains here:
the language models on the token stream, the GNNs on the reference's
synthetic graphs (its sizes), the two-tower model on its batches.
With ``mesh`` the loop runs inside ``mesh_context(mesh)`` and places
nothing else, as the reference: the activations' specs are checked, and
under a ``model`` axis the MoE layers take the expert-parallel schedule
(``models.moe.moe_forward_sharded``).
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Any, Dict, Optional

import torch

from ..configs import get_bundle
from ..core.engine.peel_loop import resolve_device
from ..data import synthetic as syn
from .sharding import mesh_context
from ..train.checkpoint import CheckpointManager
from ..train.fault_tolerance import RestartManager, StragglerMonitor
from ..train.train_step import init_train_state, make_train_step

__all__ = ["make_batch_fn", "train_loop", "main"]


def make_batch_fn(bundle, batch_size: int, seq_len: int, device=None):
    """``step -> batch`` on ``device``, seeded by the step (a restart
    replays the same stream)."""
    cfg = bundle.cfg
    if bundle.family == "lm":
        return lambda step: syn.lm_train_batch(cfg.vocab, batch_size,
                                               seq_len, seed=step,
                                               device=device)
    if bundle.family == "recsys":
        return lambda step: syn.recsys_batch(cfg, batch_size, seed=step,
                                             device=device)
    arch = bundle.arch_id
    if arch == "meshgraphnet":
        return lambda step: syn.meshgraphnet_batch(cfg, 128, 512, seed=step,
                                                   device=device)
    if arch == "graphsage-reddit":
        return lambda step: syn.graphsage_full_batch(cfg, 256, 1024,
                                                     seed=step, device=device)
    if arch == "dimenet":
        return lambda step: syn.dimenet_batch(cfg, 64, 160, triplet_fanout=6,
                                              seed=step, device=device)
    if arch == "graphcast":
        return lambda step: syn.graphcast_batch(cfg, 64, seed=step,
                                                device=device)
    raise KeyError(arch)


def train_loop(
    *,
    arch: str,
    steps: int = 100,
    batch_size: int = 8,
    seq_len: int = 64,
    ckpt_dir: Optional[str] = None,
    save_every: int = 50,
    reduced: bool = True,
    mesh=None,
    microbatches: int = 1,
    compress_grads: bool = False,
    log_every: int = 10,
    bundle=None,
    device=None,
    seed: int = 0,
) -> Dict[str, Any]:
    """``steps`` train steps from the newest checkpoint in ``ckpt_dir``
    (if any) or from params drawn with ``torch.Generator`` seed ``seed``,
    under ``mesh_context(mesh)`` when a ``DeviceMesh`` is given.  Returns
    the reference's keys (``final_loss``, ``first_loss``, ``losses``,
    ``steps``, ``wall_s``, ``state``) and ``start_step``."""
    dev = resolve_device(device)
    bundle = bundle or get_bundle(arch, reduced=reduced)
    step_fn = bundle._steps["train"]
    if (microbatches > 1 or compress_grads) and bundle._loss_fn is not None:
        # rebuild the step with the distributed-optimization options
        step_fn = make_train_step(
            bundle._loss_fn, bundle.opt_cfg,
            microbatches=microbatches, compress_grads=compress_grads,
        )
    batch_fn = make_batch_fn(bundle, batch_size, seq_len, device=dev)

    def init():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_train_state(bundle.init_params(gen), bundle.opt_cfg)

    restart = None
    start_step = 0
    if ckpt_dir:
        restart = RestartManager(CheckpointManager(ckpt_dir),
                                 save_every=save_every)
        state, start_step = restart.resume_or_init(
            bundle.state_abstract(), device=dev, init_fn=init)
        if start_step:
            print(f"[train] resumed from step {start_step}")
    else:
        state = init()

    monitor = StragglerMonitor()
    losses = []
    ctx = mesh_context(mesh) if mesh is not None else contextlib.nullcontext()
    try:
        with ctx:
            t_start = time.perf_counter()
            for step in range(start_step, start_step + steps):
                t0 = time.perf_counter()
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                losses.append(loss)
                monitor.record("train_step", time.perf_counter() - t0)
                if restart:
                    restart.maybe_save(step + 1, state, blocking=False)
                if log_every and (step % log_every == 0):
                    print(
                        f"[train] {arch} step={step} loss={loss:.4f} "
                        f"({(time.perf_counter()-t0)*1e3:.0f}ms)",
                        flush=True,
                    )
            wall = time.perf_counter() - t_start
    finally:
        if restart:
            restart.ckpt.wait()

    return {
        "final_loss": losses[-1],
        "first_loss": losses[0],
        "losses": losses,
        "steps": steps,
        "wall_s": wall,
        "state": state,
        "start_step": start_step,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="the full published config (the two-tower model "
                         "needs 4 x 17.07 GB on the card; the full language "
                         "models do not fit one card)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    out = train_loop(
        arch=args.arch, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
        save_every=args.save_every, reduced=not args.full,
        device=args.device,
    )
    print(
        f"[train] done: loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
        f"in {out['wall_s']:.1f}s"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
