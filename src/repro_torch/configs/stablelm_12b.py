"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-1_6b family; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=13824, vocab_size=100352,
    rope_theta=1e4, fsdp=True)   # 12B: fp32 Adam states need ZeRO on 16GB

SMOKE = dataclasses.replace(
    CONFIG, name="stablelm-12b-smoke", n_layers=2, d_model=160, n_heads=8,
    n_kv_heads=4, d_ff=256, vocab_size=512, remat=False, compute_dtype="float32")
