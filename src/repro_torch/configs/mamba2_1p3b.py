"""mamba2-1.3b [ssm]: 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-1.3b-smoke", n_layers=3, d_model=128,
    vocab_size=512, ssm_state=16, ssm_headdim=32, ssm_chunk=16,
    remat=False, compute_dtype="float32")
