"""Kimi-K2-Instruct [mla_moe], as published
(https://huggingface.co/moonshotai/Kimi-K2-Instruct/blob/main/config.json):
61 layers of d_model 7168, the first dense (SwiGLU 18,432), the rest
DeepSeek-V3 mixtures of 384 routed experts of width 2048 (8 a token,
sigmoid scores plus a correction bias, `noaux_tc`, top-8 weights
normalised and scaled by 2.827) beside one shared expert; multi-head
latent attention (MLA): q through a 1536-wide and k / v through a
512-wide latent, 64 heads of a 128-wide content part and a 64-wide rope
part whose key all heads share, v 128 wide; YaRN rope (theta 50,000,
factor 32 over 4,096 original positions); vocabulary 163,840, untied.

This is not the JAX package's `kimi-k2-1t-a32b` stand-in (GQA, softmax
top-k with capacity drops, no shared expert, no dense layer), which stays
in `ARCHS` beside JAX's nine others; this configuration is kept out of
`ARCHS` / `SMOKES`, whose entries `dataclasses.asdict` holds equal to JAX's.

`MLAMoEConfig` adds the fields MLA, YaRN and the DeepSeek-V3 mixture need
to `ModelConfig`.  `n_experts` is the router's width (every expert of the
layer); `experts_held` / `expert_offset` name the experts this card holds
under expert parallelism: the layer routes over all `n_experts` and
computes only the selections of its held ones (`models.moe.routed_held_ffn`).
`n_layers` counts the dense layers and the MoE layers together.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class MLAMoEConfig(ModelConfig):
    # --- multi-head latent attention ---
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    # --- YaRN rope (DeepSeek-V3's `rope_scaling`) ---
    rope_factor: float = 32.0
    rope_original_max_positions: int = 4096
    rope_beta_fast: float = 1.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 1.0
    # --- DeepSeek-V3 mixture of experts ---
    moe_d_ff: int = 2048             # each routed and shared expert's width
    n_shared_experts: int = 1
    first_k_dense: int = 1           # leading dense layers (SwiGLU d_ff)
    routed_scaling_factor: float = 2.827
    experts_held: int = 0            # 0 -> all n_experts
    expert_offset: int = 0
    aux_alpha: float = 1e-4          # sequence-wise balance loss weight
    bias_update_speed: float = 1e-3  # gamma of the correction-bias rule

    def __post_init__(self):
        if self.rope_mscale != self.rope_mscale_all_dim:
            # YaRN's cos / sin then carry mscale(factor, mscale) /
            # mscale(factor, mscale_all_dim), which no layer applies
            raise ValueError("rope_mscale must equal rope_mscale_all_dim")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def held(self) -> int:
        return self.experts_held or self.n_experts

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense

    @property
    def softmax_scale(self) -> float:
        """qk_head_dim^-0.5, times YaRN's mscale(factor, mscale_all_dim)
        squared, as DeepSeek-V3's attention sets it."""
        m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return self.qk_head_dim ** -0.5 * m * m

    def mla_params(self) -> int:
        D, H = self.d_model, self.n_heads
        return (D * self.q_lora_rank + self.q_lora_rank * H * self.qk_head_dim
                + D * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * H * (self.qk_nope_head_dim
                                           + self.v_head_dim)
                + H * self.v_head_dim * D)

    def _layer_params(self, experts: int) -> tuple[int, int]:
        """(dense layer, MoE layer) matrix parameters with `experts`
        routed experts in the MoE layer."""
        D = self.d_model
        expert = 3 * D * self.moe_d_ff
        dense = self.mla_params() + 3 * D * self.d_ff
        moe = (self.mla_params() + experts * expert
               + self.n_shared_experts * expert + D * self.n_experts)
        return dense, moe

    def param_count(self) -> int:
        """Matrix parameters held here: embedding, head, the dense layers
        and the MoE layers with their `held` experts (norms and the
        correction bias left out)."""
        dense, moe = self._layer_params(self.held)
        emb = self.vocab_size * self.d_model * (
            1 if self.tie_embeddings else 2)
        return emb + self.first_k_dense * dense + self.n_moe_layers * moe

    def active_param_count(self) -> int:
        """Matrix parameters a token touches: its `experts_per_token`
        routed experts in every MoE layer, whichever card holds them."""
        dense, moe = self._layer_params(self.experts_per_token)
        emb = self.vocab_size * self.d_model * (
            1 if self.tie_embeddings else 2)
        return emb + self.first_k_dense * dense + self.n_moe_layers * moe


def yarn_mscale(scale: float, mscale: float) -> float:
    """DeepSeek-V3's `yarn_get_mscale`."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def from_published(c: dict) -> MLAMoEConfig:
    """The configuration of `c`: a published `config.json` as a dict, its
    keys as Kimi-K2 names them, with what one card of a deployment adds:
    `name`; `router_experts`, the router's width, where `n_routed_experts`
    counts the experts held here from `expert_offset`; `aux_alpha` and
    `bias_update_speed`; `compute_dtype` and `remat`."""
    rs = c["rope_scaling"]
    return dataclasses.replace(
        CONFIG, name=c["name"], n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], n_experts=c["router_experts"],
        experts_per_token=c["num_experts_per_tok"],
        q_lora_rank=c["q_lora_rank"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        rms_norm_eps=c["rms_norm_eps"], rope_theta=float(c["rope_theta"]),
        rope_factor=rs["factor"],
        rope_original_max_positions=rs["original_max_position_embeddings"],
        rope_beta_fast=rs["beta_fast"], rope_beta_slow=rs["beta_slow"],
        rope_mscale=rs["mscale"], rope_mscale_all_dim=rs["mscale_all_dim"],
        moe_d_ff=c["moe_intermediate_size"],
        n_shared_experts=c["n_shared_experts"],
        first_k_dense=c["first_k_dense_replace"],
        routed_scaling_factor=c["routed_scaling_factor"],
        experts_held=c["n_routed_experts"], expert_offset=c["expert_offset"],
        aux_alpha=c["aux_alpha"], bias_update_speed=c["bias_update_speed"],
        compute_dtype=c["compute_dtype"], remat=c["remat"])


CONFIG = MLAMoEConfig(
    name="kimi-k2-instruct", family="mla_moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=64, d_ff=18432, vocab_size=163840,
    n_experts=384, experts_per_token=8, rope_theta=50000.0,
    compute_dtype="bfloat16", param_dtype="float32", optimizer="adamw")

SMOKE = dataclasses.replace(
    CONFIG, name="kimi-k2-instruct-smoke", n_layers=3, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=96, vocab_size=256, q_lora_rank=48,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, moe_d_ff=24, n_experts=16, experts_per_token=4,
    experts_held=4, expert_offset=4, rope_original_max_positions=16,
    remat=False, compute_dtype="float32")
