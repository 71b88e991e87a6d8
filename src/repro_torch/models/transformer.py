"""Unified model assembly for the 10 assigned architectures.

One parameter-dict + pure-function design, the JAX package's
(`models/transformer.py`), key for key and shape for shape:
  init_params(cfg, generator)    real tensors (random from `generator`)
  abstract_params(cfg)           tensors on the `meta` device (no memory)
  forward(cfg, params, batch)    logits for training/prefill
  init_cache / prefill / decode  serving path with KV / SSM caches

Families: dense (internlm2/glm4/stablelm/granite), moe (kimi/mixtral),
ssm (mamba2), hybrid (zamba2: mamba + shared attention block every k
layers), vlm (internvl2: stub patch embeddings + decoder LM), audio
(whisper: stub frame embeddings + enc-dec), and, beyond JAX's ten,
mla_moe (Kimi-K2-Instruct, `configs/kimi_k2_instruct.py`: MLA with YaRN,
dense leading layers, DeepSeek-V3 routing over every expert computing
the experts held here; training forward only).

Block parameters keep JAX's leading layer axis; each of JAX's `lax.scan`
over layers is a Python loop over one `torch.unbind` of each stacked leaf
(whose backward is one `stack`: indexing `v[i]` layer by layer would fill
and add a zero gradient of the whole stacked leaf L times).

With `cfg.remat` and autograd on, each layer of a scan runs under
`torch.utils.checkpoint` (non-reentrant): its activations are recomputed
in the backward, as under JAX's `jax.checkpoint`; `remat_policy="dots"`
keeps the outputs of `aten.mm` / `aten.addmm` (JAX's
`dots_with_no_batch_dims_saveable`).  A hybrid's shared attention block
is checkpointed as well: its f32 scores, kept for each of zamba2's six
applications, would not fit one card at a 4k sequence.  Remat changes no
value.  `cfg.scan_unroll` shapes JAX's compiled program only.  The sharded
trainer passes DTensor parameters and batches (one process a shard);
where DTensor cannot carry a sharding through an op, the op runs shard by
shard (`layers.lookup`, `layers.regroup`, `layers.batch_local`, the
attention in `layers.attention` and `layers.decode_attention`).

`mesh=` takes JAX's three mesh branches on JAX's conditions, through
`distributed.collectives`: ring attention (`attention_impl="ring"`, in
the dense / moe / vlm stacks), `_sp` (`sequence_parallel`: the hidden
state placed on P(None, "model", None) between blocks; DTensors only, a
plain tensor carries no placement) and `flash_decode` (the decode
attention of every family with a KV cache).  On DTensor parameters,
`prefill` returns its cache placed by `sharding.cache_specs`, as JAX's
prefill step's out-shardings place it, and `decode_step` writes the new
token's k / v into the one sequence shard that holds its slot.

Batches hold tensors on the parameters' device: `tokens` (B, S) integer
and, for vlm / audio, `frontend_embeds` (B, S_f, D).
"""
from __future__ import annotations

from typing import Callable

import functools

import torch
import torch.utils.checkpoint as torch_checkpoint
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.obs.trace import get_tracer

Params = dict
Cache = dict
_TRACER = get_tracer()


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cast_params(cfg: ModelConfig, params: Params) -> Params:
    """Every floating tensor in cfg.compute_dtype (`.to` hands back a
    tensor already in it as it is)."""
    cdt = _dtype(cfg.compute_dtype)
    return _tree_map(lambda a: a.to(cdt) if a.is_floating_point() else a,
                     params)


def params_on(cfg: ModelConfig, params: Params,
              device: torch.device | str) -> Params:
    """The parameters on `device`, floating ones in cfg.compute_dtype:
    one copy a leaf (none for a leaf already there in that dtype)."""
    cdt = _dtype(cfg.compute_dtype)
    return _tree_map(lambda a: a.to(device, cdt) if a.is_floating_point()
                     else a.to(device), params)


# ==========================================================================
# Parameter construction
# ==========================================================================
def _attn_shapes(cfg: ModelConfig, stacked: int | None):
    hd = cfg.resolved_head_dim
    lead = (stacked,) if stacked else ()
    return {
        "attn_norm": lead + (cfg.d_model,),
        "wq": lead + (cfg.d_model, cfg.n_heads * hd),
        "wk": lead + (cfg.d_model, cfg.n_kv_heads * hd),
        "wv": lead + (cfg.d_model, cfg.n_kv_heads * hd),
        "wo": lead + (cfg.n_heads * hd, cfg.d_model),
    }


def _mlp_shapes(cfg: ModelConfig, stacked: int | None):
    lead = (stacked,) if stacked else ()
    D, F = cfg.d_model, cfg.d_ff
    if cfg.n_experts:
        E = cfg.n_experts
        return {
            "mlp_norm": lead + (D,),
            "router": lead + (D, E),
            "w_gate": lead + (E, D, F),
            "w_in": lead + (E, D, F),
            "w_out": lead + (E, F, D),
        }
    if cfg.mlp == "swiglu":
        return {"mlp_norm": lead + (D,), "w_gate": lead + (D, F),
                "w_in": lead + (D, F), "w_out": lead + (F, D)}
    return {"mlp_norm": lead + (D,), "w_in": lead + (D, F),
            "b_in": lead + (F,), "w_out": lead + (F, D),
            "b_out": lead + (D,)}


def _mla_shapes(cfg, lead: tuple) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    return {
        "attn_norm": lead + (D,),
        "wq_a": lead + (D, cfg.q_lora_rank),
        "q_norm": lead + (cfg.q_lora_rank,),
        "wq_b": lead + (cfg.q_lora_rank, H * cfg.qk_head_dim),
        "wkv_a": lead + (D, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "kv_norm": lead + (cfg.kv_lora_rank,),
        "wkv_b": lead + (cfg.kv_lora_rank,
                         H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
        "wo": lead + (H * cfg.v_head_dim, D),
    }


def _mla_moe_shapes(cfg) -> dict:
    """The leading dense layers (`dense`, stacked) apart from the MoE
    layers (`blocks`, stacked): MLA, then a SwiGLU of width d_ff, or the
    router over all n_experts, its correction bias, the `held` routed
    experts and the shared experts (`shared_*`, their widths side by
    side)."""
    D, K, L = cfg.d_model, cfg.first_k_dense, cfg.n_moe_layers
    G, Fm, Fs = cfg.held, cfg.moe_d_ff, cfg.n_shared_experts * cfg.moe_d_ff
    return {
        "dense": {**_mla_shapes(cfg, (K,)), "mlp_norm": (K, D),
                  "w_gate": (K, D, cfg.d_ff), "w_in": (K, D, cfg.d_ff),
                  "w_out": (K, cfg.d_ff, D)},
        "blocks": {**_mla_shapes(cfg, (L,)), "mlp_norm": (L, D),
                   "router": (L, D, cfg.n_experts),
                   "e_score_correction_bias": (L, cfg.n_experts),
                   "w_gate": (L, G, D, Fm), "w_in": (L, G, D, Fm),
                   "w_out": (L, G, Fm, D), "shared_gate": (L, D, Fs),
                   "shared_in": (L, D, Fs), "shared_out": (L, Fs, D)},
    }


# leaves the model reads but no gradient trains, by name, each with its own
# rule: the train step leaves them out of the gradient and the optimizer and,
# after the update, applies the rule to the leaf with what the forward
# handed the step (`forward`'s `stats`)
BUFFERS = {
    # DeepSeek-V3's correction bias, on the step's expert loads
    "e_score_correction_bias": lambda cfg, leaf, stats: moe_lib.update_bias(
        leaf, stats["expert_load"], cfg.bias_update_speed),
}


def is_buffer(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in BUFFERS


def update_buffers(cfg: ModelConfig, flat: dict, stats: dict) -> None:
    """Each buffer among the leaves `flat` ({path: leaf}) updated in place
    by its rule (`BUFFERS`) from the step's `stats`."""
    for path, leaf in flat.items():
        if is_buffer(path):
            BUFFERS[path.rsplit("/", 1)[-1]](cfg, leaf, stats)


def _ssm_shapes(cfg: ModelConfig, stacked: int):
    dims = ssm_dims(cfg)
    L = stacked
    return {
        "norm": (L, cfg.d_model),
        "in_proj": (L, cfg.d_model, 2 * dims["d_inner"]
                    + 2 * dims["d_state"] + dims["n_heads"]),
        "conv_w": (L, dims["conv_width"], dims["conv_dim"]),
        "conv_b": (L, dims["conv_dim"]),
        "A_log": (L, dims["n_heads"]),
        "D_skip": (L, dims["n_heads"]),
        "dt_bias": (L, dims["n_heads"]),
        "norm_scale": (L, dims["d_inner"]),
        "out_proj": (L, dims["d_inner"], cfg.d_model),
    }


def ssm_dims(cfg: ModelConfig) -> dict:
    return ssm_lib.ssm_dims(cfg.d_model, expand=cfg.ssm_expand,
                            headdim=cfg.ssm_headdim, d_state=cfg.ssm_state)


def _eff_chunk(cfg: ModelConfig, S: int) -> int:
    """SSD chunk size: grows with S so the inter-chunk scan stays <= 128
    steps."""
    c = cfg.ssm_chunk
    while S > 128 * c and S % (2 * c) == 0:
        c *= 2
    return c


def param_shapes(cfg: ModelConfig, *, max_positions: int = 0) -> dict:
    """Nested dict of shapes for the whole model."""
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    tree: dict = {"embed": (V, D), "final_norm": (D,)}
    if cfg.norm == "layernorm":
        tree["final_norm_bias"] = (D,)
    if not cfg.tie_embeddings:
        tree["lm_head"] = (D, V)
    if cfg.learned_positions:
        tree["pos_embed"] = (max(max_positions, 2048), D)

    if cfg.family in ("dense", "vlm", "moe"):
        tree["blocks"] = {**_attn_shapes(cfg, L), **_mlp_shapes(cfg, L)}
    elif cfg.family == "ssm":
        tree["blocks"] = _ssm_shapes(cfg, L)
    elif cfg.family == "hybrid":
        tree["blocks"] = _ssm_shapes(cfg, L)
        shared = {**_attn_shapes(cfg, None),
                  "mlp_norm": (D,), "w_gate": (D, cfg.d_ff),
                  "w_in": (D, cfg.d_ff), "w_out": (cfg.d_ff, D)}
        tree["shared_attn"] = shared
    elif cfg.family == "mla_moe":
        tree.update(_mla_moe_shapes(cfg))
    elif cfg.family == "audio":
        enc: dict = {**_attn_shapes(cfg, cfg.encoder_layers),
                     **_mlp_shapes(cfg, cfg.encoder_layers)}
        dec: dict = {**_attn_shapes(cfg, L), **_mlp_shapes(cfg, L)}
        for k, v in _attn_shapes(cfg, L).items():
            dec["x_" + k] = v
        tree["enc_blocks"] = enc
        tree["dec_blocks"] = dec
        tree["enc_final_norm"] = (D,)
        if cfg.norm == "layernorm":
            tree["enc_final_norm_bias"] = (D,)
    else:
        raise ValueError(cfg.family)
    return tree


def _init_leaf(generator: torch.Generator, path: str, shape, dtype, device
               ) -> torch.Tensor:
    if not shape or path.endswith(("norm", "norm_scale", "D_skip", "scale")):
        return torch.ones(shape, dtype=dtype, device=device)
    if path.endswith(("_bias", "b_in", "b_out", "conv_b")):
        return torch.zeros(shape, dtype=dtype, device=device)
    if path.endswith("A_log"):
        return ssm_lib.log_linspace(shape[-1]).to(
            device=device, dtype=dtype).expand(shape).contiguous()
    if path.endswith("dt_bias"):
        return torch.full(shape, -1.0, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = min(0.02, fan_in ** -0.5)
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.mul_(scale).to(device=device, dtype=dtype)


def tree_leaves(tree: dict, prefix: str = ""):
    """(path, leaf) in JAX's flattening order (dict keys sorted)."""
    for key in sorted(tree):
        value, path = tree[key], f"{prefix}{key}"
        if isinstance(value, dict):
            yield from tree_leaves(value, path + "/")
        else:
            yield path, value


def unflatten(items: dict) -> dict:
    """The nested dict of a {"a/b/c": leaf} dict (`tree_leaves`' paths)."""
    tree: dict = {}
    for path, value in items.items():
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = value
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                max_positions: int = 0,
                device: torch.device | str = "cuda",
                place: Callable | None = None) -> Params:
    """Parameters by the JAX package's `_init_leaf` rules, in
    `cfg.param_dtype` on `device`: norms and scales ones, biases zeros,
    `A_log` the log-linspace, `dt_bias` -1, the rest normal x min(0.02,
    fan_in^-0.5), drawn from `generator` (on its own device) leaf by leaf
    in JAX's flattening order.  The random leaves are not JAX's: carry
    JAX's weights across with `convert.lm_params_from_numpy`.

    `place(path, leaf)`, where given, takes each leaf as it is drawn and
    returns what the tree keeps (the sharded trainer keeps a DTensor
    shard), so the whole tree is never built."""
    dtype = _dtype(cfg.param_dtype)
    shapes = param_shapes(cfg, max_positions=max_positions)
    place = place or (lambda path, leaf: leaf)
    return unflatten({path: place(path, _init_leaf(generator, path, shape,
                                                   dtype, device))
                       for path, shape in tree_leaves(shapes)})


def abstract_params(cfg: ModelConfig, *, max_positions: int = 0) -> Params:
    """The parameter dict as `meta` tensors: shapes and dtypes, no memory."""
    dtype = _dtype(cfg.param_dtype)
    shapes = param_shapes(cfg, max_positions=max_positions)
    return unflatten({path: torch.empty(shape, dtype=dtype, device="meta")
                       for path, shape in tree_leaves(shapes)})


# ==========================================================================
# Blocks
# ==========================================================================
def _norm(cfg, x, scale, bias=None):
    if cfg.norm == "layernorm":
        return ll.layer_norm(x, scale, bias if bias is not None
                             else torch.zeros_like(scale))
    return ll.rms_norm(x, scale)


def _bspec(mesh, B: int):
    """JAX's `bspec`: the data axes where they split the batch, else None."""
    from repro_torch.distributed import sharding as shd
    dp = shd.dp_axes(mesh)
    return dp if (B % max(shd.mesh_size(mesh, dp), 1) == 0 and dp) \
        else None


def _attn_block(cfg: ModelConfig, x, p, positions, *, causal=True,
                kv_override=None, mesh=None):
    """Pre-norm attention. kv_override=(k, v) for cross-attention."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    x = _seq_whole(x)
    h = _norm(cfg, x, p["attn_norm"])
    q = (h @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    if kv_override is None:
        k = (h @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
        v = (h @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
        if not cfg.learned_positions:
            q = ll.apply_rope(q, positions, cfg.rope_theta)
            k = ll.apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
    use_ring = (cfg.attention_impl == "ring" and mesh is not None
                and "model" in mesh.axis_names
                and kv_override is None and causal
                and not cfg.sliding_window
                and S % mesh.shape["model"] == 0)
    if use_ring:
        from repro_torch.distributed import collectives
        out = _seq_whole(collectives.ring_attention(
            mesh, dp=_bspec(mesh, B))(q, k, v))
    else:
        q_chunk = cfg.attn_chunk if S > cfg.attn_chunk_threshold else 0
        out = ll.attention(q, k, v, causal=causal and kv_override is None,
                           window=cfg.sliding_window, q_chunk=q_chunk)
    return x + out.reshape(B, S, -1) @ p["wo"]


def _mlp_block(cfg: ModelConfig, x, p):
    x = _seq_whole(x)
    h = _norm(cfg, x, p["mlp_norm"])
    if cfg.n_experts:
        B, S, D = h.shape
        # explicit redistribution (`ll.regroup`): the routing sees tokens
        # sharded on batch alone, regrouped shard by shard
        y, metrics = moe_lib.moe_ffn(
            ll.regroup(h, (B * S, D)), p["router"], p["w_gate"], p["w_in"],
            p["w_out"], top_k=cfg.experts_per_token,
            group_size=cfg.moe_group_size,
            capacity_factor=cfg.moe_capacity_factor)
        return x + ll.regroup(y, (B, S, D)), metrics.aux_loss
    if cfg.mlp == "swiglu":
        return x + ll.swiglu(h, p["w_gate"], p["w_in"], p["w_out"]), 0.0
    return x + ll.gelu_mlp(h, p["w_in"], p["b_in"], p["w_out"],
                           p["b_out"]), 0.0


_SSM_FIELDS = ("in_proj", "conv_w", "conv_b", "A_log", "D_skip", "dt_bias",
               "norm_scale", "out_proj")


def _ssm_params(p) -> ssm_lib.SSMParams:
    return ssm_lib.SSMParams(*(p[f] for f in _SSM_FIELDS))


def _layers(blocks: dict) -> list[dict]:
    """One dict a layer, from one `torch.unbind` of each stacked leaf."""
    cols = {k: torch.unbind(v) for k, v in blocks.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE
            if op in _SAVED_BY_DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """`fn` under a non-reentrant `torch.utils.checkpoint` when cfg.remat
    asks for it and autograd is on; else `fn` itself."""
    if not cfg.remat:
        return fn
    context_fn = (functools.partial(
        torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)
        if cfg.remat_policy == "dots" else torch_checkpoint.noop_context_fn)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # the bodies draw no random numbers: no RNG state to stash
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                           preserve_rng_state=False,
                                           context_fn=context_fn)
    return run


# ==========================================================================
# Forward (training / prefill body)
# ==========================================================================
def _sp(cfg: ModelConfig, mesh, x):
    """Sequence-parallel constraint: shard S over 'model' between blocks
    (JAX's P(None, "model", None): the batch whole).  A redistribution of
    a DTensor, which changes no value; a plain tensor is left as it is."""
    if not (cfg.sequence_parallel and mesh is not None
            and "model" in mesh.axis_names):
        return x
    if x.shape[1] % mesh.shape["model"] or not isinstance(x, DTensor):
        return x
    from repro_torch.distributed import sharding as shd
    return x.redistribute(x.device_mesh, shd.placements(
        shd.P(None, "model", None), x.device_mesh))


def _seq_whole(x):
    """`x` whole along the sequence (dim 1): a DTensor that `_sp` (or the
    ring) left sharded there is gathered, anything else is returned as
    it is.  Explicit redistribution: under torch 2.11 DTensor refuses the
    (B·S, D) view that a product of a sequence-sharded activation (or its
    gradient) takes, so each block gathers its input and the ring's
    output (Megatron's all-gather before a tensor-parallel product), its
    residual sum and every product's gradient stay whole along the
    sequence, and `_sp` shards the block's output again."""
    if not isinstance(x, DTensor) or not any(
            p.is_shard(1) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(1) else p for p in x.placements])


def _scan_blocks(cfg: ModelConfig, x, layers: list, body, mesh=None):
    """JAX's `lax.scan` (under `jax.checkpoint` with cfg.remat) over the
    layers, with `_sp` before and after every block: (x, summed aux)."""
    body = _remat(cfg, body)
    x = _sp(cfg, mesh, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layers:
        x, a = body(x, p)
        x = _sp(cfg, mesh, x)
        aux = aux + a
    return x, aux


def _decoder_stack(cfg: ModelConfig, x, params, positions, mesh=None):
    """dense / moe / vlm decoder-only stack."""
    def body(h, p):
        h = _attn_block(cfg, h, p, positions, mesh=mesh)
        return _mlp_block(cfg, h, p)
    return _scan_blocks(cfg, x, _layers(params["blocks"]), body, mesh=mesh)


def _ssm_body(cfg: ModelConfig):
    dims = ssm_dims(cfg)

    def block(h, norm, *fields):
        hn = ll.rms_norm(h, norm)
        return ssm_lib.ssd_forward(ssm_lib.SSMParams(*fields), hn, dims,
                                   chunk=_eff_chunk(cfg, hn.shape[1]))

    def body(h, p):
        # each batch shard runs the SSD block on its own rows
        # (`ll.batch_local`: an explicit placement)
        return h + ll.batch_local(block, h, p["norm"],
                                  *(p[f] for f in _SSM_FIELDS)), 0.0
    return body


def _hybrid_segments(cfg: ModelConfig):
    """(start, stop, shared attention after?) for zamba2's schedule: the
    shared block after every `attn_every` mamba layers."""
    k, L = cfg.attn_every, cfg.n_layers
    start = 0
    while start < L:
        stop = min(start + k, L)
        yield start, stop, stop < L or stop % k == 0
        start = stop


def _hybrid_stack(cfg: ModelConfig, x, params, positions):
    """zamba2: mamba stack with a SHARED attention block every k layers."""
    shared = params["shared_attn"]
    layers = _layers(params["blocks"])
    body = _ssm_body(cfg)

    def attend_block(h, p):
        h = _attn_block(cfg, h, p, positions)
        return _mlp_block(cfg, h, p)[0]

    attend_block = _remat(cfg, attend_block)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for start, stop, attend in _hybrid_segments(cfg):
        x, a = _scan_blocks(cfg, x, layers[start:stop], body)
        aux = aux + a
        if attend:
            x = attend_block(x, shared)
    return x, aux


def _whisper_encode(cfg: ModelConfig, params, frames):
    """frames: (B, S_f, D) stub conv-frontend output."""
    x = frames.to(_dtype(cfg.compute_dtype))
    x = x + ll.sinusoidal_positions(x.shape[1], cfg.d_model,
                                    x.device).to(x.dtype)

    def body(h, p):
        h = _attn_block(cfg, h, p, None, causal=False)
        return _mlp_block(cfg, h, p)

    x, _ = _scan_blocks(cfg, x, _layers(params["enc_blocks"]), body)
    return _norm(cfg, x, params["enc_final_norm"],
                 params.get("enc_final_norm_bias"))


def _cross(p: dict) -> dict:
    return {k[2:]: v for k, v in p.items() if k.startswith("x_")}


def _cross_kv(cfg: ModelConfig, enc_out, xp):
    hd = cfg.resolved_head_dim
    B, Se, _ = enc_out.shape
    xk = (enc_out @ xp["wk"]).reshape(B, Se, cfg.n_kv_heads, hd)
    xv = (enc_out @ xp["wv"]).reshape(B, Se, cfg.n_kv_heads, hd)
    return xk, xv


def _whisper_decode_stack(cfg: ModelConfig, x, params, enc_out, positions):
    def body(h, p):
        h = _attn_block(cfg, h, p, positions)
        # cross-attention: kv from encoder output
        xp = _cross(p)
        h = _attn_block(cfg, h, xp, None,
                        kv_override=_cross_kv(cfg, enc_out, xp))
        return _mlp_block(cfg, h, p)

    return _scan_blocks(cfg, x, _layers(params["dec_blocks"]), body)


def _embed_tokens(cfg, params, tokens, positions):
    x = ll.lookup(params["embed"], tokens).to(_dtype(cfg.compute_dtype))
    if cfg.learned_positions:
        pos = positions if positions is not None else torch.arange(
            tokens.shape[1], device=tokens.device)
        x = x + ll.lookup(params["pos_embed"], pos).to(x.dtype)
    return x


def _logits(cfg, params, x):
    """f32 logits from f32 copies of the operands (JAX: an f32 product)."""
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return torch.einsum("bsd,dv->bsv", x.float(), head.to(x.dtype).float())


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None, :]


def forward(cfg: ModelConfig, params: Params, batch: dict,
            mesh=None, stats: dict | None = None) -> tuple:
    """Training/prefill forward -> (logits, aux_loss).

    batch: tokens (B, S) [+ frontend_embeds (B, S_f, D) for vlm/audio].
    `stats`, where given, receives what a step needs beside the loss:
    for mla_moe `expert_load`, the (MoE layers, n_experts) selections of
    each expert (the correction bias's rule reads it), and
    `held_selections`, the selections the experts held here computed,
    summed over the layers (0-d: a metric of the step).
    """
    if cfg.family == "mla_moe":
        return _mla_moe_forward(cfg, params, batch["tokens"], stats)
    params = _cast_params(cfg, params)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(S, tokens.device)

    if cfg.family == "audio":
        enc_out = _whisper_encode(cfg, params, batch["frontend_embeds"])
        x = _embed_tokens(cfg, params, tokens, positions[0])
        x, aux = _whisper_decode_stack(cfg, x, params, enc_out, positions)
    elif cfg.family == "vlm":
        x_txt = _embed_tokens(cfg, params, tokens, None)
        x_img = batch["frontend_embeds"].to(x_txt.dtype)
        x = torch.cat([x_img, x_txt], dim=1)
        x, aux = _decoder_stack(cfg, x, params,
                                _positions(x.shape[1], x.device), mesh=mesh)
        x = _seq_whole(x)[:, x_img.shape[1]:, :]        # text positions only
    elif cfg.family == "ssm":
        x = _embed_tokens(cfg, params, tokens, None)
        x, aux = _scan_blocks(cfg, x, _layers(params["blocks"]),
                              _ssm_body(cfg))
    elif cfg.family == "hybrid":
        x = _embed_tokens(cfg, params, tokens, None)
        x, aux = _hybrid_stack(cfg, x, params, positions)
    else:
        x = _embed_tokens(cfg, params, tokens, None)
        x, aux = _decoder_stack(cfg, x, params, positions, mesh=mesh)

    x = _norm(cfg, _seq_whole(x), params["final_norm"],
              params.get("final_norm_bias"))
    return _logits(cfg, params, x), aux


# ==========================================================================
# mla_moe: DeepSeek-V3's block at Kimi-K2's settings
# (configs/kimi_k2_instruct.py)
# ==========================================================================
def _mla_attn_block(cfg, x, p, positions):
    """Pre-norm multi-head latent attention: q = wq_b(norm(wq_a h)), its
    first qk_nope_head_dim columns a head the content part, the rest the
    rope part; wkv_a h = [latent, one rope key for all heads]; wkv_b
    (norm(latent)) = [k content, v] a head; k = [k content, the rope key];
    YaRN rope; causal attention at `cfg.softmax_scale`; then wo."""
    B, S, _ = x.shape
    H, eps = cfg.n_heads, cfg.rms_norm_eps
    nope, rope, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    inv_freq = ll.yarn_frequencies(
        rope, cfg.rope_theta, cfg.rope_factor,
        cfg.rope_original_max_positions, cfg.rope_beta_fast,
        cfg.rope_beta_slow, x.device)
    h = ll.rms_norm(x, p["attn_norm"], eps)
    q = (ll.rms_norm(h @ p["wq_a"], p["q_norm"], eps) @ p["wq_b"]
         ).reshape(B, S, H, nope + rope)
    latent, k_rope = (h @ p["wkv_a"]).split([cfg.kv_lora_rank, rope], -1)
    k_nope, v = (ll.rms_norm(latent, p["kv_norm"], eps) @ p["wkv_b"]
                 ).reshape(B, S, H, nope + dv).split([nope, dv], -1)
    q_nope, q_rope = q.split([nope, rope], -1)
    q = torch.cat([q_nope, ll.apply_rope_freqs(q_rope, positions,
                                               inv_freq)], -1)
    k_rope = ll.apply_rope_freqs(k_rope[:, :, None, :], positions, inv_freq)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], -1)
    with _TRACER.span("dispatch/mla_attention", "kernel", device=x.device,
                      shapes=str([tuple(q.shape), tuple(k.shape),
                                  tuple(v.shape)]), causal=True,
                      dtype=str(q.dtype)):
        out = ll.fused_causal_attention(q, k, v, cfg.softmax_scale)
    return x + out.reshape(B, S, H * dv) @ p["wo"]


def _held_moe_block(cfg, x, p, router, bias):
    """Pre-norm DeepSeek-V3 mixture: routing over every expert
    (`moe.sigmoid_route`, the router `router` and correction bias `bias`
    in f32), the held experts' part dropless (`moe.routed_held_ffn`), and
    the shared experts on every token.  -> (x, balance loss, load)."""
    B, S, D = x.shape
    h = ll.rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps).reshape(B * S, D)
    with _TRACER.span("moe/route", "moe", device=x.device) as sp:
        route = moe_lib.sigmoid_route(
            h, router, bias, top_k=cfg.experts_per_token,
            scaling=cfg.routed_scaling_factor, n_seqs=B)
        held = moe_lib.hold(route, cfg.expert_offset, cfg.held)
        sp.set(tokens=B * S, selections_held=sum(held.rows),
               load_max=max(held.rows), load_min=min(held.rows),
               dropped=held.chosen - held.selections.numel())
    y = moe_lib.routed_held_ffn(h, route, held, p["w_gate"], p["w_in"],
                                p["w_out"])
    y = y + ll.swiglu(h, p["shared_gate"], p["shared_in"], p["shared_out"])
    return x + y.reshape(B, S, D), route.aux_loss, route.load


_MLA_MOE_F32 = ("router", "e_score_correction_bias")


def _mla_moe_forward(cfg, params, tokens, stats):
    """Embedding, the dense layers, the MoE layers (each under remat with
    cfg.remat), the final norm and f32 logits.  The embedding, the router
    and its correction bias are read from their f32 leaves: the rows are
    looked up in f32 and then cast, so that the embedding's gradient, a
    sum over every occurrence of a token (thousands for a frequent id in
    16,384 tokens), adds up in f32 (summed in bfloat16 it came out 28%
    short at the benchmark's size); every other weight is used in
    cfg.compute_dtype."""
    blocks = params["blocks"]
    router, bias = (blocks[k] for k in _MLA_MOE_F32)
    x = ll.lookup(params["embed"], tokens).to(_dtype(cfg.compute_dtype))
    params = _cast_params(cfg, {
        **{k: v for k, v in params.items() if k != "embed"},
        "blocks": {k: v for k, v in blocks.items()
                   if k not in _MLA_MOE_F32}})
    positions = _positions(tokens.shape[1], tokens.device)

    def dense_body(h, p):
        with _TRACER.span("train/mla_layer", "train", device=h.device):
            h = _mla_attn_block(cfg, h, p, positions)
        hn = ll.rms_norm(h, p["mlp_norm"], cfg.rms_norm_eps)
        return h + ll.swiglu(hn, p["w_gate"], p["w_in"], p["w_out"])

    def moe_body(h, p, w_router, b):
        with _TRACER.span("train/mla_layer", "train", device=h.device):
            h = _mla_attn_block(cfg, h, p, positions)
        with _TRACER.span("train/moe_layer", "train", device=h.device):
            return _held_moe_block(cfg, h, p, w_router, b)

    dense_body, moe_body = _remat(cfg, dense_body), _remat(cfg, moe_body)
    for p in _layers(params["dense"]):
        x = dense_body(x, p)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    loads = []
    for p, w_router, b in zip(_layers(params["blocks"]),
                              torch.unbind(router), torch.unbind(bias)):
        x, a, load = moe_body(x, p, w_router, b)
        aux = aux + a
        loads.append(load)
    if stats is not None:
        load = stats["expert_load"] = torch.stack(loads)
        stats["held_selections"] = load[
            :, cfg.expert_offset:cfg.expert_offset + cfg.held].sum()
    x = ll.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(cfg, params, x), aux


# ==========================================================================
# Serving: caches, prefill, decode
# ==========================================================================
def hybrid_n_apps(cfg: ModelConfig) -> int:
    """Number of shared-attention applications in the hybrid schedule."""
    return sum(attend for _, _, attend in _hybrid_segments(cfg))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               abstract: bool = False,
               device: torch.device | str = "cuda") -> Cache:
    """Zeroed serving cache; with `abstract=True` its tensors are on the
    `meta` device (shapes and dtypes only)."""
    hd = cfg.resolved_head_dim
    cdt = _dtype(cfg.compute_dtype)
    dev = "meta" if abstract else device

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: Cache = {"pos": mk((), torch.int32)}
    if cfg.family in ("dense", "moe", "vlm"):
        kv = min(max_seq, cfg.sliding_window) if cfg.sliding_window \
            else max_seq
        cache["k"] = mk((cfg.n_layers, batch, kv, cfg.n_kv_heads, hd), cdt)
        cache["v"] = mk((cfg.n_layers, batch, kv, cfg.n_kv_heads, hd), cdt)
    elif cfg.family == "audio":
        cache["k"] = mk((cfg.n_layers, batch, max_seq, cfg.n_kv_heads, hd),
                        cdt)
        cache["v"] = mk((cfg.n_layers, batch, max_seq, cfg.n_kv_heads, hd),
                        cdt)
        cache["xk"] = mk((cfg.n_layers, batch, cfg.frontend_seq,
                          cfg.n_kv_heads, hd), cdt)
        cache["xv"] = mk((cfg.n_layers, batch, cfg.frontend_seq,
                          cfg.n_kv_heads, hd), cdt)
    if cfg.family in ("ssm", "hybrid"):
        dims = ssm_dims(cfg)
        cache["h"] = mk((cfg.n_layers, batch, dims["n_heads"],
                         dims["d_state"], dims["headdim"]), torch.float32)
        cache["conv"] = mk((cfg.n_layers, batch, dims["conv_width"] - 1,
                            dims["conv_dim"]), cdt)
    if cfg.family == "hybrid":
        n_apps = hybrid_n_apps(cfg)
        cache["ak"] = mk((n_apps, batch, max_seq, cfg.n_kv_heads, hd), cdt)
        cache["av"] = mk((n_apps, batch, max_seq, cfg.n_kv_heads, hd), cdt)
    return cache


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot) -> None:
    """cache[:, slot] = new, in place.  cache: (B, S, ...); new: (B, 1,
    ...); slot: a 0-d integer tensor.  On a DTensor cache sharded on S
    each shard writes only where it holds the slot (a masked write of
    its own block: no host branch on the slot, so no host sync)."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, slot.reshape(1).long(), new.to(cache.dtype))
        return
    mesh = cache.device_mesh
    new = new.redistribute(mesh, ll.batch_placements(cache)).to_local()
    local = cache.to_local()
    _, offset = ll.local_shape_and_offset(cache.shape, mesh,
                                          cache.placements)
    at = slot - offset[1]
    inside = (at >= 0) & (at < local.shape[1])
    at = torch.clamp(at, 0, local.shape[1] - 1).reshape(1).long()
    local.index_copy_(1, at, torch.where(inside, new.to(local.dtype),
                                         local.index_select(1, at)))


def _decode_attn_block(cfg, x, p, kc, vc, pos, mesh=None):
    """One-token attention with cache update. x: (B, 1, D); kc / vc:
    (B, S, KVH, hd), written in place at the token's slot; pos: 0-d int32
    tensor."""
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    S = kc.shape[1]
    h = _norm(cfg, x, p["attn_norm"])
    q = (h @ p["wq"]).reshape(B, 1, cfg.n_heads, hd)
    k = (h @ p["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
    v = (h @ p["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
    if not cfg.learned_positions:
        pvec = pos.reshape(1, 1).expand(B, 1)
        q = ll.apply_rope(q, pvec, cfg.rope_theta)
        k = ll.apply_rope(k, pvec, cfg.rope_theta)
    # SWA: ring-buffer write; full: linear write.  JAX's slot rule: after a
    # prefill longer than the window, whose tail fills slots 0..S-1 in
    # order, `pos % S` can overwrite a key still inside the window.
    slot = torch.remainder(pos, S) if cfg.sliding_window else \
        torch.clamp(pos, max=S - 1)
    _write_slot(kc, k, slot)
    _write_slot(vc, v, slot)
    valid = torch.clamp(pos + 1, max=S) if cfg.sliding_window else pos + 1
    if cfg.flash_decode and mesh is not None:
        from repro_torch.distributed import collectives
        fd = collectives.flash_decode(mesh, dp=_bspec(mesh, B))
        out = fd(q.select(1, 0), kc, vc, valid).unsqueeze(1)
    else:
        out = ll.decode_attention(q, kc, vc, valid)
    return x + out.reshape(B, 1, -1) @ p["wo"]


def _ssm_decode(cfg: ModelConfig, x, p, hc, cc):
    """One SSM layer's decode step: x plus its output; the layer's state
    and conv tail written into hc / cc in place.  On a DTensor cache each
    batch shard steps its own rows with the whole state of its rows and
    the weights gathered, and keeps its own shard of the new state (an
    explicit placement, as `layers.batch_local` in the forward)."""
    dims = ssm_dims(cfg)

    def step(h, state, conv, norm, *fields):
        return ssm_lib.ssd_decode_step(ssm_lib.SSMParams(*fields),
                                       ll.rms_norm(h, norm),
                                       ssm_lib.SSMCache(state, conv), dims)

    weights = [p["norm"], *(p[f] for f in _SSM_FIELDS)]
    if not isinstance(hc, DTensor):
        y, c2 = step(x, hc, cc, *weights)
        hc.copy_(c2.h)
        cc.copy_(c2.conv)
        return x + y
    mesh, rows = hc.device_mesh, ll.batch_placements(hc)
    whole = [Replicate()] * mesh.ndim
    local = [t.redistribute(mesh, rows).to_local() for t in (x, hc, cc)]
    w = [t.redistribute(mesh, whole).to_local() if isinstance(t, DTensor)
         else t for t in weights]
    y, c2 = step(*local, *w)
    for dst, new in ((hc, c2.h), (cc, c2.conv)):
        shape, offset = ll.local_shape_and_offset(dst.shape, mesh,
                                                  dst.placements)
        for d in range(1, new.dim()):
            new = new.narrow(d, offset[d], shape[d])
        dst.to_local().copy_(new)
    return x + ll.from_local(y.contiguous(), mesh, rows, x.shape)


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, *, mesh=None) -> tuple:
    """tokens: (B, 1) -> (logits (B, 1, V), updated cache).

    The new token's k/v (and, for ssm / hybrid, each layer's state and
    conv tail) are written into the tensors of the cache it is given; the
    returned dict holds those same tensors and a new `pos`.  Clone a cache
    before this call to keep it."""
    params = _cast_params(cfg, params)
    pos = cache["pos"]
    pos_l = pos.to_local() if isinstance(pos, DTensor) else pos
    B = tokens.shape[0]
    x = ll.lookup(params["embed"], tokens).to(_dtype(cfg.compute_dtype))
    if cfg.learned_positions:
        x = x + ll.lookup(params["pos_embed"], pos_l.reshape(1).long())[
            None].to(x.dtype)
    new_cache = dict(cache)

    if cfg.family in ("dense", "moe", "vlm"):
        for i, p in enumerate(_layers(params["blocks"])):
            x = _decode_attn_block(cfg, x, p, cache["k"][i], cache["v"][i],
                                   pos_l, mesh=mesh)
            x, _ = _mlp_block(cfg, x, p)

    elif cfg.family == "ssm":
        for i, p in enumerate(_layers(params["blocks"])):
            x = _ssm_decode(cfg, x, p, cache["h"][i], cache["conv"][i])

    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        layers = _layers(params["blocks"])
        app = 0
        for start, stop, attend in _hybrid_segments(cfg):
            for i in range(start, stop):
                x = _ssm_decode(cfg, x, layers[i], cache["h"][i],
                                cache["conv"][i])
            if attend:
                x = _decode_attn_block(cfg, x, shared, cache["ak"][app],
                                       cache["av"][app], pos_l, mesh=mesh)
                x, _ = _mlp_block(cfg, x, shared)
                app += 1

    elif cfg.family == "audio":
        hd_ = cfg.resolved_head_dim
        for i, p in enumerate(_layers(params["dec_blocks"])):
            x = _decode_attn_block(cfg, x, p, cache["k"][i], cache["v"][i],
                                   pos_l, mesh=mesh)
            xp = _cross(p)
            hq = _norm(cfg, x, xp["attn_norm"])
            q = (hq @ xp["wq"]).reshape(B, 1, cfg.n_heads, hd_)
            xk, xv = cache["xk"][i], cache["xv"][i]
            # JAX's plain decode attention over the cross cache (gathered
            # where `cache_specs` shards it on S)
            out = ll.decode_attention(q, xk, xv, xk.shape[1])
            x = x + out.reshape(B, 1, -1) @ xp["wo"]
            x, _ = _mlp_block(cfg, x, p)

    new_cache["pos"] = pos + 1
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_bias"))
    return _logits(cfg, params, x), new_cache


def _prefill_kv(cfg, hn, p, positions, B, S):
    hd = cfg.resolved_head_dim
    hn = _seq_whole(hn)
    k = (hn @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (hn @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if not cfg.learned_positions:
        k = ll.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _store_kv(cache_k, ks, S):
    """Write stacked (L, B, S, KVH, hd) prefill k/v into the cache; a cache
    shorter than S (sliding window) takes the last kv_len positions, in
    slots 0..kv_len-1, as in JAX."""
    kv_len = cache_k.shape[2]
    if kv_len >= S:
        cache_k[:, :, :S] = ks.to(cache_k.dtype)
        return cache_k
    return ks[:, :, S - kv_len:].to(cache_k.dtype).contiguous()  # SWA tail


def _pos_scalar(n: int, device) -> torch.Tensor:
    return torch.full((), n, dtype=torch.int32, device=device)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on this rank; a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _place_cache(cfg: ModelConfig, cache: Cache, mesh) -> Cache:
    """A whole serving cache (alike on every rank) as DTensors placed by
    `sharding.cache_specs` on `mesh` (a `DeviceMesh`), the counterpart of
    the out-shardings of JAX's prefill step: each rank keeps a copy of
    its own slice only."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    batch = next(v.shape[1] for k, v in cache.items() if k != "pos")
    shape = ShapeConfig("cache", 0, batch, "decode")
    specs = shd.fit_specs(shd.cache_specs(cfg, shape, mesh), cache, mesh)
    out = {}
    for key, leaf in cache.items():
        placed = shd.place(leaf, mesh, specs[key], src_data_rank=None)
        out[key] = ll.from_local(placed.to_local().clone(), mesh,
                                 placed.placements, leaf.shape)
    return out


def prefill(cfg: ModelConfig, params: Params, batch: dict,
            max_seq: int, mesh=None) -> tuple:
    """Full-sequence forward filling the serving cache.

    Returns (last-position logits, cache).  For vlm, batch carries
    frontend_embeds prepended to the token sequence (total length must be
    <= max_seq); for audio, frontend_embeds feed the encoder and the
    cross-attention KV is precomputed here.
    """
    params = _cast_params(cfg, params)
    tokens = batch["tokens"]
    B, S = tokens.shape
    device = tokens.device
    cache = init_cache(cfg, B, max_seq, device=device)

    if cfg.family in ("dense", "moe", "vlm"):
        if cfg.family == "vlm":
            x_txt = _embed_tokens(cfg, params, tokens, None)
            x_img = batch["frontend_embeds"].to(x_txt.dtype)
            x = torch.cat([x_img, x_txt], dim=1)
        else:
            x = _embed_tokens(cfg, params, tokens,
                              torch.arange(S, device=device))
        St = x.shape[1]
        positions = _positions(St, device)
        ks, vs = [], []
        x = _sp(cfg, mesh, x)
        for p in _layers(params["blocks"]):
            hn = _norm(cfg, x, p["attn_norm"])
            k, v = _prefill_kv(cfg, hn, p, positions, B, St)
            ks.append(_whole(k))
            vs.append(_whole(v))
            x = _attn_block(cfg, x, p, positions, mesh=mesh)
            x, _ = _mlp_block(cfg, x, p)
            x = _sp(cfg, mesh, x)
        cache["k"] = _store_kv(cache["k"], torch.stack(ks), St)
        cache["v"] = _store_kv(cache["v"], torch.stack(vs), St)
        cache["pos"] = _pos_scalar(St, device)

    elif cfg.family in ("ssm", "hybrid"):
        x = _embed_tokens(cfg, params, tokens, None)
        positions = _positions(S, device)
        dims = ssm_dims(cfg)
        hs, convs, aks, avs = [], [], [], []
        layers = _layers(params["blocks"])

        def block(h, norm, *fields):
            y, c = ssm_lib.ssd_forward(ssm_lib.SSMParams(*fields),
                                       ll.rms_norm(h, norm), dims,
                                       chunk=_eff_chunk(cfg, S),
                                       return_cache=True)
            return y, c.h, c.conv

        def ssm_layers(x, start, stop):
            for p in layers[start:stop]:
                # each batch shard on its own rows (`ll.batch_local`)
                y, h, conv = ll.batch_local(block, x, p["norm"],
                                            *(p[f] for f in _SSM_FIELDS))
                x = x + y
                hs.append(_whole(h))
                convs.append(_whole(conv))
            return x

        if cfg.family == "ssm":
            x = ssm_layers(x, 0, cfg.n_layers)
        else:
            shared = params["shared_attn"]
            for start, stop, attend in _hybrid_segments(cfg):
                x = ssm_layers(x, start, stop)
                if attend:
                    hn = _norm(cfg, x, shared["attn_norm"])
                    k, v = _prefill_kv(cfg, hn, shared, positions, B, S)
                    aks.append(_whole(k))
                    avs.append(_whole(v))
                    x = _attn_block(cfg, x, shared, positions)
                    x, _ = _mlp_block(cfg, x, shared)
            cache["ak"] = _store_kv(cache["ak"], torch.stack(aks), S)
            cache["av"] = _store_kv(cache["av"], torch.stack(avs), S)
        cache["h"], cache["conv"] = torch.stack(hs), torch.stack(convs)
        cache["pos"] = _pos_scalar(S, device)

    elif cfg.family == "audio":
        enc_out = _whisper_encode(cfg, params, batch["frontend_embeds"])
        x = _embed_tokens(cfg, params, tokens,
                          torch.arange(S, device=device))
        positions = _positions(S, device)
        ks, vs, xks, xvs = [], [], [], []
        for p in _layers(params["dec_blocks"]):
            hn = _norm(cfg, x, p["attn_norm"])
            k, v = _prefill_kv(cfg, hn, p, positions, B, S)
            x = _attn_block(cfg, x, p, positions)
            xp = _cross(p)
            xk, xv = _cross_kv(cfg, enc_out, xp)
            x = _attn_block(cfg, x, xp, None, kv_override=(xk, xv))
            x, _ = _mlp_block(cfg, x, p)
            for acc, t in zip((ks, vs, xks, xvs), (k, v, xk, xv)):
                acc.append(_whole(t))
        cache["k"] = _store_kv(cache["k"], torch.stack(ks), S)
        cache["v"] = _store_kv(cache["v"], torch.stack(vs), S)
        cache["xk"] = torch.stack(xks).to(cache["xk"].dtype)
        cache["xv"] = torch.stack(xvs).to(cache["xv"].dtype)
        cache["pos"] = _pos_scalar(S, device)
    else:
        raise ValueError(cfg.family)

    if isinstance(x, DTensor):
        cache = _place_cache(cfg, cache, x.device_mesh)
    x = _norm(cfg, _seq_whole(x), params["final_norm"],
              params.get("final_norm_bias"))
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits, cache
