"""Minitron 8B (pruned Nemotron) [arXiv:2407.14679; hf] (port of
``repro.configs.minitron_8b``)."""
import torch

from ..models.transformer import LMConfig
from ..train.optimizer import AdamWConfig

ARCH_ID = "minitron-8b"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=32, d_model=4_096, n_heads=32, n_kv_heads=8,
        d_ff=16_384, vocab=256_000, d_head=128, attn_kind="gqa",
        param_dtype=torch.bfloat16,
    )


def opt_config() -> AdamWConfig:
    return AdamWConfig(state_dtype=torch.float32)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=128, d_head=16, q_block=16, kv_block=16,
    )
