"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA [hf:THUDM/glm-4-9b; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=151552,
    rope_theta=1e4)

SMOKE = dataclasses.replace(
    CONFIG, name="glm4-9b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, d_ff=192, vocab_size=512, remat=False, compute_dtype="float32")
