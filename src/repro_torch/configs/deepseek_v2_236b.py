"""DeepSeek-V2 236B: MLA (kv_lora=512) + MoE 160 routed top-6, 2 shared
[arXiv:2405.04434; hf] (port of ``repro.configs.deepseek_v2_236b``)."""
import torch

from ..models.transformer import LMConfig
from ..train.optimizer import AdamWConfig

ARCH_ID = "deepseek-v2-236b"


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=60, d_model=5_120, n_heads=128, n_kv_heads=128,
        d_ff=12_288, vocab=102_400, attn_kind="mla",
        q_lora=1_536, kv_lora=512, d_nope=128, d_rope=64, d_v=128,
        moe=True, n_routed=160, n_shared=2, top_k=6, d_ff_moe=1_536,
        n_dense_layers=1, router_mode="softmax_topk",
        param_dtype=torch.bfloat16,
    )


def opt_config() -> AdamWConfig:
    return AdamWConfig(state_dtype=torch.bfloat16)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=128, attn_kind="mla",
        q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16,
        moe=True, n_routed=8, n_shared=2, top_k=2, d_ff_moe=32,
        n_dense_layers=1, capacity_factor=8.0, q_block=16, kv_block=16,
    )
