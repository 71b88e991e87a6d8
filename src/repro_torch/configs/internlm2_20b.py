"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA [arXiv:2403.17297; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=92544,
    rope_theta=1e6, fsdp=True)

SMOKE = dataclasses.replace(
    CONFIG, name="internlm2-20b-smoke", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=4, d_ff=256, vocab_size=512, fsdp=False, remat=False, compute_dtype="float32")
