"""DeepSeek 67B (llama-arch dense) [arXiv:2401.02954; hf] (port of
``repro.configs.deepseek_67b``)."""
import torch

from ..models.transformer import LMConfig
from ..train.optimizer import AdamWConfig

ARCH_ID = "deepseek-67b"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=95, d_model=8_192, n_heads=64, n_kv_heads=8,
        d_ff=22_016, vocab=102_400, d_head=128, attn_kind="gqa",
        param_dtype=torch.bfloat16,
    )


def opt_config() -> AdamWConfig:
    return AdamWConfig(state_dtype=torch.float32)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=128, d_head=16, q_block=16, kv_block=16,
    )
