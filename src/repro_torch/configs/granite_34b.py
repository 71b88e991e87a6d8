"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab_size=49152,
    rope_theta=1e4, fsdp=True, mlp="gelu")

SMOKE = dataclasses.replace(
    CONFIG, name="granite-34b-smoke", n_layers=3, d_model=128, n_heads=8,
    n_kv_heads=1, d_ff=384, vocab_size=512, fsdp=False, remat=False, compute_dtype="float32")
