"""The plain reference of one card's share of Kimi-K2-Instruct's training
step (`configs/kimi_k2_instruct.json`): the forward pass, the loss, the
gradients (autograd of plain operations), DeepSeek-V3's correction-bias
rule and a plain AdamW, in float32 unless a caller asks for a lower
precision (the controls).  It imports nothing of the program and nothing of
JAX; the benchmark's own copy and the tests' are this one file.

A configuration `c` is the dict of the configuration file, keys as the
published `config.json` names them: `n_routed_experts` is the number of
experts held here (experts `expert_offset` ..), `router_experts` the
router's width (every expert of the layer).  Parameters are a flat dict
{path: tensor}, paths as `param_shapes` lays them out (the program's
layout, so that the benchmark can hand the same weights to both).

Departures from the published modeling code (DeepSeek-V3's
`modeling_deepseek.py`, which Kimi-K2 runs), none of which random weights
can tell apart or the published equations leave open:
  * rope is applied to rotate-half pairs (x[:32], x[32:]) where DeepSeek's
    code first de-interleaves (x[0::2], x[1::2]): a fixed permutation of
    the rope columns of `wq_b` and `wkv_a`;
  * weights are stored input-major (x @ w, w of shape (in, out)), the
    router too (x @ router, (D, E)), where the published checkpoints keep
    torch `Linear`'s (out, in);
  * the sequence-wise balance loss is the DeepSeek-V3 paper's (eq. 17-20:
    P_i from the scores normalised over all experts); the published code
    computes no loss for `noaux_tc`;
  * the expert layer is one card's share under expert parallelism: it
    routes over all `router_experts`, computes the selections of the
    experts it holds, and leaves out what the others would add; the loads
    of the bias rule are counted on this card's tokens;
  * the vocabulary is a slice of the published one (ids 0 .. V - 1), and
    logits and loss are over the slice.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ATTN_BLOCK = 256          # query rows of one attention block
LOSS_BLOCK = 2048         # tokens of one block of the loss


# -- layout and weights ------------------------------------------------------
def _mla_shapes(c: dict, lead: tuple) -> dict:
    D, H = c["hidden_size"], c["num_attention_heads"]
    nope, rope = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    return {"attn_norm": lead + (D,),
            "wq_a": lead + (D, c["q_lora_rank"]),
            "q_norm": lead + (c["q_lora_rank"],),
            "wq_b": lead + (c["q_lora_rank"], H * (nope + rope)),
            "wkv_a": lead + (D, c["kv_lora_rank"] + rope),
            "kv_norm": lead + (c["kv_lora_rank"],),
            "wkv_b": lead + (c["kv_lora_rank"], H * (nope + c["v_head_dim"])),
            "wo": lead + (H * c["v_head_dim"], D)}


def param_shapes(c: dict) -> dict:
    """{path: shape}: embedding and head, the leading dense layers stacked
    under `dense/`, the MoE layers stacked under `blocks/`."""
    D, V = c["hidden_size"], c["vocab_size"]
    K = c["first_k_dense_replace"]
    L = c["num_hidden_layers"] - K
    G, Fm = c["n_routed_experts"], c["moe_intermediate_size"]
    Fs, Fd = c["n_shared_experts"] * Fm, c["intermediate_size"]
    E = c["router_experts"]
    out = {"embed": (V, D), "lm_head": (D, V), "final_norm": (D,)}
    dense = {**_mla_shapes(c, (K,)), "mlp_norm": (K, D),
             "w_gate": (K, D, Fd), "w_in": (K, D, Fd), "w_out": (K, Fd, D)}
    moe = {**_mla_shapes(c, (L,)), "mlp_norm": (L, D), "router": (L, D, E),
           "e_score_correction_bias": (L, E), "w_gate": (L, G, D, Fm),
           "w_in": (L, G, D, Fm), "w_out": (L, G, Fm, D),
           "shared_gate": (L, D, Fs), "shared_in": (L, D, Fs),
           "shared_out": (L, Fs, D)}
    out.update({f"dense/{k}": v for k, v in dense.items()})
    out.update({f"blocks/{k}": v for k, v in moe.items()})
    return dict(sorted(out.items()))


def is_buffer(path: str) -> bool:
    """The correction bias: read by the routing, trained by no gradient."""
    return path.endswith("e_score_correction_bias")


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + index) % (2 ** 63 - 1)


def init_leaf(c: dict, seed: int, path: str, device) -> torch.Tensor:
    """The float32 weights of leaf `path`, from its own generator (so any
    leaf can be made again alone): norm scales ones, the correction bias
    normal of standard deviation c["init"]["bias_std"], every matrix
    normal of standard deviation min(0.02, fan_in^-0.5)."""
    names = list(param_shapes(c))
    shape = param_shapes(c)[path]
    if path.endswith("norm"):
        return torch.ones(shape, device=device)
    g = torch.Generator(device=device).manual_seed(
        leaf_seed(seed, names.index(path)))
    std = (c["init"]["bias_std"] if is_buffer(path)
           else min(0.02, shape[-2] ** -0.5))
    return torch.randn(shape, generator=g, device=device).mul_(std)


def init_params(c: dict, seed: int, device) -> dict:
    return {p: init_leaf(c, seed, p, device) for p in param_shapes(c)}


# -- the model --------------------------------------------------------------
def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _swiglu(x, wg, wi, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def yarn_frequencies(c: dict, device) -> torch.Tensor:
    """DeepSeek-V3's YaRN inverse frequencies for the rope part."""
    dim, theta = c["qk_rope_head_dim"], float(c["rope_theta"])
    rs = c["rope_scaling"]
    orig = rs["original_max_position_embeddings"]

    def corr(rotations):
        return dim * np.log(orig / (rotations * 2 * np.pi)) / (
            2 * np.log(theta))
    low = max(int(np.floor(corr(rs["beta_fast"]))), 0)
    high = min(int(np.ceil(corr(rs["beta_slow"]))), dim - 1)
    high = high + 0.001 if low == high else high
    base = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64)
                           / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    inv = base / rs["factor"] * ramp + base * (1 - ramp)
    return inv.float().to(device)


def softmax_scale(c: dict) -> float:
    rs = c["rope_scaling"]
    m = 1.0
    if rs["factor"] > 1:
        m = 0.1 * rs["mscale_all_dim"] * float(np.log(rs["factor"])) + 1.0
    return (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5 * m * m


def _rope(x, inv_freq):
    """x: (B, S, H, d), rotate-half pairs, angles in float32."""
    S, half = x.shape[1], x.shape[-1] // 2
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * inv_freq[None, :]
    cos, sin = (t.to(x.dtype)[None, :, None, :]
                for t in (torch.cos(ang), torch.sin(ang)))
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attend_rows(q, k, v, start: int, scale: float):
    """Causal attention of the query rows start .. start + rows - 1 over
    keys 0 .. start + rows - 1."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    rows = torch.arange(q.shape[1], device=q.device)[:, None] + start
    keys = torch.arange(k.shape[1], device=q.device)[None, :]
    scores = scores.masked_fill(keys > rows, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


def attention(q, k, v, scale: float, block: int = ATTN_BLOCK):
    """Causal softmax attention in blocks of query rows, each recomputed in
    the backward, so that no (H, S, S) block is ever kept."""
    outs = []
    for s0 in range(0, q.shape[1], block):
        s1 = min(s0 + block, q.shape[1])
        outs.append(checkpoint(_attend_rows, q[:, s0:s1], k[:, :s1],
                               v[:, :s1], s0, scale, use_reentrant=False))
    return torch.cat(outs, 1)


def mla(c: dict, x, p: dict, inv_freq):
    B, S, _ = x.shape
    H, eps = c["num_attention_heads"], c["rms_norm_eps"]
    nope, rope, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
    h = _rms(x, p["attn_norm"], eps)
    q = (_rms(h @ p["wq_a"], p["q_norm"], eps) @ p["wq_b"]).reshape(
        B, S, H, nope + rope)
    kv_a = h @ p["wkv_a"]
    latent, k_rope = kv_a[..., :c["kv_lora_rank"]], kv_a[..., None,
                                                        c["kv_lora_rank"]:]
    kv = (_rms(latent, p["kv_norm"], eps) @ p["wkv_b"]).reshape(
        B, S, H, nope + dv)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], inv_freq)], -1)
    k_rope = _rope(k_rope, inv_freq).expand(B, S, H, rope)
    k = torch.cat([kv[..., :nope], k_rope], -1)
    out = attention(q, k, kv[..., nope:], softmax_scale(c))
    return x + out.reshape(B, S, H * dv) @ p["wo"]


def route(c: dict, h, router, bias, n_seqs: int):
    """(experts (T, k), weights (T, k), sequence-wise balance loss, loads
    (E,)): sigmoid scores of f32... of h @ router in the reference's
    precision, the top-k of scores + bias (ties to the lower index),
    weights the chosen scores normalised and scaled."""
    k, E = c["num_experts_per_tok"], c["router_experts"]
    scores = torch.sigmoid(h @ router)
    choice = scores + bias.detach()
    order = torch.sort(choice, dim=-1, descending=True, stable=True).indices
    experts = order[:, :k]
    chosen = scores.gather(1, experts)
    weights = chosen / (chosen.sum(-1, keepdim=True) + 1e-20) \
        * c["routed_scaling_factor"]
    loads = torch.zeros(E, dtype=torch.int64, device=h.device)
    loads.index_add_(0, experts.reshape(-1),
                     torch.ones_like(experts.reshape(-1)))
    T = h.shape[0]
    S = T // n_seqs
    aux = 0.0
    for b in range(n_seqs):
        e_b = experts[b * S:(b + 1) * S].reshape(-1)
        f = torch.zeros(E, dtype=scores.dtype, device=h.device).index_add_(
            0, e_b, torch.ones_like(e_b, dtype=scores.dtype)) * (E / (k * S))
        s_b = scores[b * S:(b + 1) * S]
        P = (s_b / s_b.sum(-1, keepdim=True)).mean(0)
        aux = aux + (f * P).sum()
    return experts, weights, aux / n_seqs, loads


def held_experts(c: dict, h, experts, weights, p: dict):
    """The held experts' part: each selection of expert offset + e (e <
    n_routed_experts) through that expert, times its weight, summed onto its
    token; every other selection adds nothing."""
    y = torch.zeros_like(h)
    for e in range(c["n_routed_experts"]):
        tok, slot = torch.nonzero(experts == c["expert_offset"] + e,
                                  as_tuple=True)
        if tok.numel():
            out = _swiglu(h[tok], p["w_gate"][e], p["w_in"][e],
                          p["w_out"][e])
            y = y.index_add(0, tok, out * weights[tok, slot, None])
    return y


def moe(c: dict, x, p: dict):
    B, S, D = x.shape
    h = _rms(x, p["mlp_norm"], c["rms_norm_eps"]).reshape(B * S, D)
    experts, weights, aux, loads = route(c, h, p["router"],
                                         p["e_score_correction_bias"], B)
    y = held_experts(c, h, experts, weights.to(h.dtype), p) + _swiglu(
        h, p["shared_gate"], p["shared_in"], p["shared_out"])
    return x + y.reshape(B, S, D), aux, loads


def _layer(prefix: str, i: int, params: dict) -> dict:
    return {k[len(prefix):]: v[i] for k, v in params.items()
            if k.startswith(prefix)}


def forward(c: dict, params: dict, tokens, dtype=torch.float32):
    """(final hidden states (B, S, D), summed balance loss, loads (MoE
    layers, E)); every layer recomputed in the backward."""
    inv_freq = yarn_frequencies(c, tokens.device)
    p = {k: v.to(dtype) for k, v in params.items()}
    x = p["embed"][tokens]
    eps = c["rms_norm_eps"]

    def dense(x, lp):
        x = mla(c, x, lp, inv_freq)
        return x + _swiglu(_rms(x, lp["mlp_norm"], eps), lp["w_gate"],
                           lp["w_in"], lp["w_out"])

    def moe_layer(x, lp):
        return moe(c, mla(c, x, lp, inv_freq), lp)

    for i in range(c["first_k_dense_replace"]):
        x = checkpoint(dense, x, _layer("dense/", i, p), use_reentrant=False)
    aux, loads = 0.0, []
    for i in range(c["num_hidden_layers"] - c["first_k_dense_replace"]):
        x, a, load = checkpoint(moe_layer, x, _layer("blocks/", i, p),
                                use_reentrant=False)
        aux, loads = aux + a, loads + [load]
    return _rms(x, p["final_norm"], eps), aux, torch.stack(loads)


def _ce_block(x, head, labels):
    logits = x @ head
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss(c: dict, params: dict, tokens, labels, dtype=torch.float32):
    """(total, mean cross entropy, balance loss, loads); the cross entropy
    in blocks of tokens, each recomputed in the backward.  Float32
    products run as float32, not TF32 (set here, where the reference
    runs, not when the module is imported)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, aux, loads = forward(c, params, tokens, dtype)
    x = x.reshape(-1, x.shape[-1])
    labels = labels.reshape(-1)
    head = params["lm_head"].to(dtype)
    ce = 0.0
    for t0 in range(0, x.shape[0], LOSS_BLOCK):
        ce = ce + checkpoint(_ce_block, x[t0:t0 + LOSS_BLOCK], head,
                             labels[t0:t0 + LOSS_BLOCK], use_reentrant=False)
    ce = ce / x.shape[0]
    return ce + c["aux_alpha"] * aux, ce, aux, loads


# -- the step ---------------------------------------------------------------
def learning_rate(c: dict, count: int) -> float:
    """The linear warmup's rate at step `count` (1-based); the steps the
    check replays lie inside the warmup."""
    a = c["adamw"]
    if count >= a["warmup_steps"]:
        raise ValueError(f"step {count} is past the warmup: the reference "
                         "replays warmup steps only")
    return a["peak_lr"] * count / a["warmup_steps"]


def step(c: dict, params: dict, state: dict, tokens, labels, count: int,
         dtype=torch.float32, leaf_dtype=torch.float32) -> dict:
    """One training step in place on `params` (kept in `leaf_dtype`) and
    `state` (AdamW's m and v, float32): gradients of the total loss in
    `dtype`, the global norm clipped to `clip_norm`, AdamW with decoupled
    weight decay, then each MoE layer's correction bias moved by
    bias_update_speed x sign(mean load - load).  Returns the step's
    cross entropy, gradient norm (before clipping) and loads."""
    a = c["adamw"]
    names = [n for n in params if not is_buffer(n)]
    leaves = {n: params[n].detach().requires_grad_() for n in names}
    total, ce, _, loads = loss(c, {**params, **leaves}, tokens, labels,
                               dtype)
    grads = torch.autograd.grad(total, [leaves[n] for n in names])
    del leaves, total
    with torch.no_grad():
        gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = min(1.0, a["clip_norm"] / (float(gnorm) + 1e-9))
        lr = learning_rate(c, count)
        c1, c2 = 1 - a["b1"] ** count, 1 - a["b2"] ** count
        for n, g in zip(names, grads):
            g = g.float() * scale
            m, v = state.setdefault(n, (torch.zeros_like(g),
                                        torch.zeros_like(g)))
            m.mul_(a["b1"]).add_((1 - a["b1"]) * g)
            v.mul_(a["b2"]).add_((1 - a["b2"]) * g * g)
            p = params[n]
            upd = -lr * ((m / c1) / (torch.sqrt(v / c2) + a["eps"])
                         + a["weight_decay"] * p.float())
            params[n] = (p.float() + upd).to(leaf_dtype)
        del grads
        bias = "blocks/e_score_correction_bias"
        lf = loads.double()
        params[bias] = params[bias] + c["bias_update_speed"] * torch.sign(
            lf.mean(-1, keepdim=True) - lf).to(params[bias].dtype)
    return {"ce": float(ce.detach()), "grad_norm": float(gnorm),
            "loads": loads}
