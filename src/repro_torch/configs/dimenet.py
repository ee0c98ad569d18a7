"""DimeNet [arXiv:2003.03123; unverified] (port of
``repro.configs.dimenet``)."""
import torch

from ..models.gnn import DimeNetConfig
from ..train.optimizer import AdamWConfig

ARCH_ID = "dimenet"


def full_config() -> DimeNetConfig:
    return DimeNetConfig(
        name=ARCH_ID, n_blocks=6, d_hidden=128, n_bilinear=8,
        n_spherical=7, n_radial=6, carry_dtype=torch.bfloat16,
    )


def opt_config() -> AdamWConfig:
    return AdamWConfig()


def reduced_config() -> DimeNetConfig:
    return DimeNetConfig(
        name=ARCH_ID + "-reduced", n_blocks=2, d_hidden=16, n_bilinear=2,
        n_spherical=3, n_radial=2, d_node_in=4,
    )
