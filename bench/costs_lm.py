"""The yardstick's arithmetic for the LM training cells: the operations and
bytes of a piece of an LM step, and the least time an NVIDIA H100 could
take for them.

Each input byte is read once and each output byte written once: a grouped
product's intermediates (a fused kernel writes none) and a step's
recomputation (remat) are not counted.  Attention is causal: a sequence of
S positions has S (S + 1) / 2 query-key pairs, each 2 x (Dqk + Dv)
operations in the forward (scores and the value product).  A training step
is 6 operations a parameter a token for the products (forward 2, backward
4), the held experts' counted by the rows routed to them, plus three times
the attention's forward (forward and a backward of twice its work).

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit: 989
TFLOP/s of dense bfloat16 on the tensor cores (every product here takes
bfloat16 operands) and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BW = 3.35e12
BF16 = 2


def bound_s(moved: float, ops: float) -> float:
    """The least seconds one card takes to move `moved` bytes and do `ops`
    bfloat16 tensor-core operations."""
    return max(moved / HBM_BW, ops / BF16_FLOPS)


def mla_attention(batch: int, seq: int, heads: int, d_qk: int, d_v: int
                  ) -> tuple[int, int]:
    """(bytes, operations) of one causal attention forward over (batch,
    seq, heads) with q / k of width d_qk and v of d_v, in bfloat16: q, k,
    v read and the output written."""
    pairs = batch * heads * seq * (seq + 1) // 2
    moved = BF16 * batch * seq * heads * (2 * d_qk + 2 * d_v)
    return moved, 2 * pairs * (d_qk + d_v)


def expert_product(rows: list[int], d_model: int, d_ff: int
                   ) -> tuple[int, int]:
    """(bytes, operations) of one held-expert SwiGLU forward over its
    grouped products: each expert's w_gate, w_in (d_model x d_ff) and
    w_out (d_ff x d_model) read, its rows read and their outputs written,
    in bfloat16; three products of 2 x d_model x d_ff operations a row."""
    n = sum(rows)
    moved = BF16 * (3 * len(rows) * d_model * d_ff + 2 * n * d_model)
    return moved, 6 * n * d_model * d_ff


def mla_params(lm: dict) -> int:
    D, H = lm["d_model"], lm["heads"]
    return (D * lm["q_lora"] + lm["q_lora"] * H * (lm["nope"] + lm["rope"])
            + D * (lm["kv_lora"] + lm["rope"])
            + lm["kv_lora"] * H * (lm["nope"] + lm["v_dim"])
            + H * lm["v_dim"] * D)


def train_step(lm: dict, held_rows: float) -> int:
    """Model operations of one training step of the mla_moe stack `lm`
    (the driver's shape facts) with `held_rows` routed rows computed by
    the held experts over all MoE layers."""
    T = lm["batch"] * lm["seq_len"]
    D = lm["d_model"]
    dense = mla_params(lm) + 3 * D * lm["d_ff"]
    moe = (mla_params(lm) + 3 * D * lm["moe_d_ff"] * lm["shared"]
           + D * lm["experts"])
    n_moe = lm["layers"] - lm["dense_layers"]
    per_token = dense * lm["dense_layers"] + moe * n_moe + D * lm["vocab"]
    _, attn = mla_attention(lm["batch"], lm["seq_len"], lm["heads"],
                            lm["nope"] + lm["rope"], lm["v_dim"])
    return int(6 * T * per_token + 6 * held_rows * 3 * D * lm["moe_d_ff"]
               + 3 * attn * lm["layers"])
