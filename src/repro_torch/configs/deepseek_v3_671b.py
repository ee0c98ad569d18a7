"""DeepSeek-V3 671B: MLA + MoE 256 routed top-8 (sigmoid aux-free), 1
shared, MTP [arXiv:2412.19437; hf] (port of
``repro.configs.deepseek_v3_671b``)."""
import torch

from ..models.transformer import LMConfig
from ..train.optimizer import AdamWConfig

ARCH_ID = "deepseek-v3-671b"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=61, d_model=7_168, n_heads=128, n_kv_heads=128,
        d_ff=18_432, vocab=129_280, attn_kind="mla",
        q_lora=1_536, kv_lora=512, d_nope=128, d_rope=64, d_v=128,
        moe=True, n_routed=256, n_shared=1, top_k=8, d_ff_moe=2_048,
        n_dense_layers=3, router_mode="sigmoid_bias", mtp=True,
        param_dtype=torch.bfloat16,
    )


def opt_config() -> AdamWConfig:
    # bf16 m/v: 671B * (2 + 2 + 2) bytes / 512 chips ~ 7.9 GB/chip
    return AdamWConfig(state_dtype=torch.bfloat16)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=128, attn_kind="mla",
        q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16,
        moe=True, n_routed=8, n_shared=1, top_k=2, d_ff_moe=32,
        n_dense_layers=1, router_mode="sigmoid_bias", mtp=True,
        capacity_factor=8.0, q_block=16, kv_block=16,
    )
