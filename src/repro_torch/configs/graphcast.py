"""GraphCast encoder-processor-decoder mesh GNN [arXiv:2212.12794;
unverified] (port of ``repro.configs.graphcast``)."""
import torch

from ..models.gnn import GraphCastConfig
from ..train.optimizer import AdamWConfig

ARCH_ID = "graphcast"


def full_config() -> GraphCastConfig:
    return GraphCastConfig(
        name=ARCH_ID, n_layers=16, d_hidden=512, mesh_refinement=6,
        n_vars=227, carry_dtype=torch.bfloat16,
    )


def opt_config() -> AdamWConfig:
    return AdamWConfig()


def reduced_config() -> GraphCastConfig:
    return GraphCastConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_hidden=16,
        mesh_refinement=1, n_vars=5, mlp_layers=1,
    )
