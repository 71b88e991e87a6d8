"""Config schema: architectures (assigned pool) and workload shapes.

The port's copy of the JAX package's `configs/base.py`: the same fields,
defaults and arithmetic, so `dataclasses.asdict` of every config equals
JAX's.  `scan_unroll` changes nothing in the port's eager models;
`remat` / `remat_policy` choose what a training backward recomputes
(`models/transformer.py`), never a value; the mesh fields
(`attention_impl="ring"`, `flash_decode`, `sequence_parallel`) choose
the models' mesh branches when a mesh is passed
(`distributed/collectives.py`), as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_group_size: int = 1024
    moe_capacity_factor: float = 1.25
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    attn_every: int = 0          # hybrid: shared attn block every k layers
    # --- attention ---
    rope_theta: float = 1e6
    sliding_window: int = 0      # SWA (mixtral)
    attn_chunk: int = 1024       # row-blocked attention q-chunk for long seq
    attn_chunk_threshold: int = 4096
    # --- enc-dec / frontends ---
    encoder_layers: int = 0      # whisper encoder depth
    frontend: str = ""           # "" | "vision" | "audio" (stub embeddings)
    frontend_seq: int = 0        # patches / frames provided by the stub
    norm: str = "rmsnorm"        # rmsnorm | layernorm (whisper)
    mlp: str = "swiglu"          # swiglu | gelu
    learned_positions: bool = False
    tie_embeddings: bool = False
    # --- lowering ---
    scan_unroll: bool = False    # dry-run: unroll scans so cost_analysis
    #                              counts loop bodies x trip_count (XLA
    #                              counts a `while` body once)
    # --- numerics / training ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save matmul outputs only)
    optimizer: str = "adamw"     # adamw | adafactor (1T-param models)
    # --- distribution ---
    fsdp: bool = False           # shard weights over the data axis too
    moe_shard: str = "expert"    # expert (EP) | ffn (TP inside experts)
    #                            | expert2d (EP over model x d_ff over data:
    #                              reshards activations instead of
    #                              all-gathering expert weights)
    flash_decode: bool = False   # shard_map LSE-combined decode attention
    #                              over the seq-sharded KV cache (no
    #                              per-layer KV all-gather)
    attention_impl: str = "auto"  # auto | ring (sequence-sharded ring
    #                              attention via shard_map ppermute; the fix
    #                              for head counts that cannot shard the
    #                              model axis)
    sequence_parallel: bool = False  # constrain hidden states to shard the
    #                              sequence dim over "model": removes the
    #                              16x replicated compute when head counts
    #                              cannot shard the model axis (small archs)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def param_count(self) -> int:
        """Approximate total parameters (embeddings + blocks)."""
        D, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            attn = D * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * D
            if self.n_experts:
                ffn = self.n_experts * 3 * D * self.d_ff + D * self.n_experts
            else:
                mult = 3 if self.mlp == "swiglu" else 2
                ffn = mult * D * self.d_ff
            per_layer = attn + ffn
        elif self.family in ("ssm", "hybrid"):
            d_inner = self.ssm_expand * D
            H = d_inner // self.ssm_headdim
            proj = D * (2 * d_inner + 2 * self.ssm_state + H)
            per_layer = proj + d_inner * D
        total = emb + L * per_layer
        if self.family == "hybrid" and self.attn_every:
            attn = D * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * D
            total += attn + 3 * D * self.d_ff          # one shared block
        if self.family == "audio":
            total += self.encoder_layers * per_layer    # encoder stack
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        attn = D * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * D
        ffn = self.experts_per_token * 3 * D * self.d_ff
        return emb + L * (attn + ffn + D * self.n_experts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Archs that may run long_500k (sub-quadratic decode): SSM state decode or
# sliding-window attention.  Pure full-attention archs skip it (DESIGN.md
# SSArch-applicability).
SUBQUADRATIC = {"mamba2-1.3b", "zamba2-1.2b", "mixtral-8x22b"}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.name in SUBQUADRATIC:
        names.append("long_500k")
    return names
