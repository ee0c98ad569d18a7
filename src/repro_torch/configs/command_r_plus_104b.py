"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01; unverified] (port
of ``repro.configs.command_r_plus_104b``)."""
import torch

from ..models.transformer import LMConfig
from ..train.optimizer import AdamWConfig

ARCH_ID = "command-r-plus-104b"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=64, d_model=12_288, n_heads=96, n_kv_heads=8,
        d_ff=33_792, vocab=256_000, d_head=128, attn_kind="gqa",
        param_dtype=torch.bfloat16, rope_theta=75_000_000.0,
    )


def opt_config() -> AdamWConfig:
    return AdamWConfig(state_dtype=torch.float32)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=128, vocab=128, d_head=8, attn_kind="gqa",
        q_block=16, kv_block=16,
    )
