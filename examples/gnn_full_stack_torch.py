"""GNN stack example on the PyTorch/CUDA port (``repro_torch``): train all
four assigned GNN archs (reduced configs) on synthetic graphs, then run a
GraphSAGE minibatch epoch with the REAL fixed-fanout neighbour sampler.

The counterpart of ``examples/gnn_full_stack.py``, step for step.

    PYTHONPATH=src python examples/gnn_full_stack_torch.py                # the card
    PYTHONPATH=src python examples/gnn_full_stack_torch.py --device cpu
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_bundle
from repro_torch.core.engine.peel_loop import resolve_device
from repro_torch.data import synthetic as syn
from repro_torch.launch.train import train_loop
from repro_torch.train.train_step import init_train_state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--minibatches", type=int, default=10)
    args = ap.parse_args()
    dev = resolve_device(args.device)

    for arch in ("meshgraphnet", "graphsage-reddit", "dimenet", "graphcast"):
        out = train_loop(arch=arch, steps=args.steps, log_every=10,
                         device=dev)
        print(f"[{arch}] loss {out['first_loss']:.4f} -> {out['final_loss']:.4f}")

    # GraphSAGE minibatch epoch with the real sampler
    b = get_bundle("graphsage-reddit", reduced=True)
    params = b.init_params(torch.Generator(device=dev).manual_seed(0))
    state = init_train_state(params, b.opt_cfg)
    step = b._steps["train_sampled"]
    for i in range(args.minibatches):
        blocks = syn.graphsage_sampled_batch(
            b.cfg, batch_nodes=32, fanouts=b.cfg.sample_sizes,
            n_nodes=500, n_edges=2500, seed=i, device=dev,
        )
        state, metrics = step(state, blocks)
    print(f"[graphsage minibatch] final loss {float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
