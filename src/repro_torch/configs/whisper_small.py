"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H (kv=12)
d_ff=3072 vocab=51865 — enc-dec, conv frontend stub [arXiv:2212.04356].

The conv1d mel frontend is a stub providing precomputed frame embeddings
(1500 frames), per the assignment. LayerNorm + GELU, learned positions."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=51865,
    encoder_layers=12, frontend="audio", frontend_seq=1500,
    norm="layernorm", mlp="gelu", learned_positions=True)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-small-smoke", n_layers=2, encoder_layers=2,
    d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
    frontend_seq=32, remat=False, compute_dtype="float32")
