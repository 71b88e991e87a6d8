"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) expert d_ff=16384
vocab=32768, MoE 8e top-2, SWA [arXiv:2401.04088; hf].

8 experts < 16-way model axis -> moe_shard="ffn" (TP inside experts).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=32768,
    n_experts=8, experts_per_token=2, moe_shard="ffn",
    sliding_window=4096, rope_theta=1e6, fsdp=True)

SMOKE = dataclasses.replace(
    CONFIG, name="mixtral-8x22b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=4, d_ff=128, vocab_size=512, n_experts=4,
    experts_per_token=2, moe_group_size=64, moe_capacity_factor=8.0, sliding_window=32,
    fsdp=False, remat=False, compute_dtype="float32")
