"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE [arXiv:2501.kimi2].

1T-param note: Adam needs ~12 TB of optimizer state for 1T params — more
than a 512-chip x 16 GB pod; config uses Adafactor + FSDP (DESIGN.md SS5).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_ff=2048, vocab_size=163840,
    n_experts=384, experts_per_token=8, moe_shard="expert",
    rope_theta=5e7, fsdp=True, optimizer="adafactor",
    param_dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, name="kimi-k2-1t-a32b-smoke", n_layers=2, d_model=128,
    n_heads=8, n_kv_heads=4, d_ff=64, vocab_size=512, n_experts=8,
    experts_per_token=2, moe_group_size=64, moe_capacity_factor=8.0, fsdp=False, remat=False, compute_dtype="float32",
    param_dtype="float32", optimizer="adamw")
