"""MeshGraphNet [arXiv:2010.03409; unverified] (port of
``repro.configs.meshgraphnet``)."""
import torch

from ..models.gnn import MeshGraphNetConfig
from ..train.optimizer import AdamWConfig

ARCH_ID = "meshgraphnet"


def full_config() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(
        name=ARCH_ID, n_layers=15, d_hidden=128, mlp_layers=2,
        aggregator="sum", carry_dtype=torch.bfloat16,
    )


def opt_config() -> AdamWConfig:
    return AdamWConfig()


def reduced_config() -> MeshGraphNetConfig:
    return MeshGraphNetConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_hidden=16, mlp_layers=1,
        d_node_in=4, d_edge_in=3, d_out=2,
    )
