"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2 [arXiv:2404.16821; hf].

Backbone only; the ViT frontend is a stub providing precomputed patch
embeddings (input_specs), per the assignment."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab_size=151655,
    frontend="vision", frontend_seq=256, rope_theta=1e6)

SMOKE = dataclasses.replace(
    CONFIG, name="internvl2-1b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512, frontend_seq=16, remat=False, compute_dtype="float32")
