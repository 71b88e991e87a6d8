"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks
[arXiv:2411.15242; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, attn_every=6, rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-1.2b-smoke", n_layers=5, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab_size=512, ssm_state=16, ssm_headdim=32,
    attn_every=2, ssm_chunk=16, remat=False, compute_dtype="float32")
