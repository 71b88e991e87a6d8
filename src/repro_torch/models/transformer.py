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
(whisper: stub frame embeddings + enc-dec).

Block parameters keep JAX's leading layer axis; each of JAX's `lax.scan`
over layers is a Python loop over `p[i]` here.  `cfg.remat` and
`cfg.scan_unroll` shape JAX's compiled program and change nothing in
eager execution.  Only `mesh=None` is served: ring attention,
`flash_decode` and `sequence_parallel` need the distributed LM pieces
(ROADMAP A11b).

Batches hold tensors on the parameters' device: `tokens` (B, S) integer
and, for vlm / audio, `frontend_embeds` (B, S_f, D).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

Params = dict
Cache = dict


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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port's LM models run on one device (mesh=None); ring "
            "attention, flash_decode and sequence_parallel need the "
            "distributed LM pieces (ROADMAP A11b)")


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


def _unflatten(items: dict) -> dict:
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
                device: torch.device | str = "cuda") -> Params:
    """Parameters by the JAX package's `_init_leaf` rules, in
    `cfg.param_dtype` on `device`: norms and scales ones, biases zeros,
    `A_log` the log-linspace, `dt_bias` -1, the rest normal x min(0.02,
    fan_in^-0.5), drawn from `generator` (on its own device) leaf by leaf
    in JAX's flattening order.  The random leaves are not JAX's: carry
    JAX's weights across with `convert.lm_params_from_numpy`."""
    dtype = _dtype(cfg.param_dtype)
    shapes = param_shapes(cfg, max_positions=max_positions)
    return _unflatten({path: _init_leaf(generator, path, shape, dtype,
                                        device)
                       for path, shape in tree_leaves(shapes)})


def abstract_params(cfg: ModelConfig, *, max_positions: int = 0) -> Params:
    """The parameter dict as `meta` tensors: shapes and dtypes, no memory."""
    dtype = _dtype(cfg.param_dtype)
    shapes = param_shapes(cfg, max_positions=max_positions)
    return _unflatten({path: torch.empty(shape, dtype=dtype, device="meta")
                       for path, shape in tree_leaves(shapes)})


# ==========================================================================
# Blocks
# ==========================================================================
def _norm(cfg, x, scale, bias=None):
    if cfg.norm == "layernorm":
        return ll.layer_norm(x, scale, bias if bias is not None
                             else torch.zeros_like(scale))
    return ll.rms_norm(x, scale)


def _attn_block(cfg: ModelConfig, x, p, positions, *, causal=True,
                kv_override=None):
    """Pre-norm attention. kv_override=(k, v) for cross-attention."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
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
    q_chunk = cfg.attn_chunk if S > cfg.attn_chunk_threshold else 0
    out = ll.attention(q, k, v, causal=causal and kv_override is None,
                       window=cfg.sliding_window, q_chunk=q_chunk)
    return x + out.reshape(B, S, -1) @ p["wo"]


def _mlp_block(cfg: ModelConfig, x, p):
    h = _norm(cfg, x, p["mlp_norm"])
    if cfg.n_experts:
        B, S, D = h.shape
        y, metrics = moe_lib.moe_ffn(
            h.reshape(B * S, D), p["router"], p["w_gate"], p["w_in"],
            p["w_out"], top_k=cfg.experts_per_token,
            group_size=cfg.moe_group_size,
            capacity_factor=cfg.moe_capacity_factor)
        return x + y.reshape(B, S, D), metrics.aux_loss
    if cfg.mlp == "swiglu":
        return x + ll.swiglu(h, p["w_gate"], p["w_in"], p["w_out"]), 0.0
    return x + ll.gelu_mlp(h, p["w_in"], p["b_in"], p["w_out"],
                           p["b_out"]), 0.0


_SSM_FIELDS = ("in_proj", "conv_w", "conv_b", "A_log", "D_skip", "dt_bias",
               "norm_scale", "out_proj")


def _ssm_params(p) -> ssm_lib.SSMParams:
    return ssm_lib.SSMParams(*(p[f] for f in _SSM_FIELDS))


def _layer(blocks: dict, i: int) -> dict:
    return {k: v[i] for k, v in blocks.items()}


def _n_layers(blocks: dict) -> int:
    return next(iter(blocks.values())).shape[0]


# ==========================================================================
# Forward (training / prefill body)
# ==========================================================================
def _scan_blocks(x, blocks, body):
    """JAX's `lax.scan` over the stacked layers: (x, summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_n_layers(blocks)):
        x, a = body(x, _layer(blocks, i))
        aux = aux + a
    return x, aux


def _decoder_stack(cfg: ModelConfig, x, params, positions):
    """dense / moe / vlm decoder-only stack."""
    def body(h, p):
        h = _attn_block(cfg, h, p, positions)
        return _mlp_block(cfg, h, p)
    return _scan_blocks(x, params["blocks"], body)


def _ssm_body(cfg: ModelConfig):
    dims = ssm_dims(cfg)

    def body(h, p):
        hn = ll.rms_norm(h, p["norm"])
        return h + ssm_lib.ssd_forward(_ssm_params(p), hn, dims,
                                       chunk=_eff_chunk(cfg, hn.shape[1])
                                       ), 0.0
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
    blocks = params["blocks"]
    body = _ssm_body(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for start, stop, attend in _hybrid_segments(cfg):
        seg = {k: v[start:stop] for k, v in blocks.items()}
        x, a = _scan_blocks(x, seg, body)
        aux = aux + a
        if attend:
            x = _attn_block(cfg, x, shared, positions)
            x, _ = _mlp_block(cfg, x, shared)
    return x, aux


def _whisper_encode(cfg: ModelConfig, params, frames):
    """frames: (B, S_f, D) stub conv-frontend output."""
    x = frames.to(_dtype(cfg.compute_dtype))
    x = x + ll.sinusoidal_positions(x.shape[1], cfg.d_model,
                                    x.device).to(x.dtype)

    def body(h, p):
        h = _attn_block(cfg, h, p, None, causal=False)
        return _mlp_block(cfg, h, p)

    x, _ = _scan_blocks(x, params["enc_blocks"], body)
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

    return _scan_blocks(x, params["dec_blocks"], body)


def _embed_tokens(cfg, params, tokens, positions):
    x = params["embed"][tokens].to(_dtype(cfg.compute_dtype))
    if cfg.learned_positions:
        pos = positions if positions is not None else torch.arange(
            tokens.shape[1], device=tokens.device)
        x = x + params["pos_embed"][pos].to(x.dtype)
    return x


def _logits(cfg, params, x):
    """f32 logits from f32 copies of the operands (JAX: an f32 product)."""
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return torch.einsum("bsd,dv->bsv", x.float(), head.to(x.dtype).float())


def _positions(S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None, :]


def forward(cfg: ModelConfig, params: Params, batch: dict,
            mesh=None) -> tuple:
    """Training/prefill forward -> (logits, aux_loss).

    batch: tokens (B, S) [+ frontend_embeds (B, S_f, D) for vlm/audio].
    """
    _no_mesh(mesh)
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
                                _positions(x.shape[1], x.device))
        x = x[:, x_img.shape[1]:, :]                    # text positions only
    elif cfg.family == "ssm":
        x = _embed_tokens(cfg, params, tokens, None)
        x, aux = _scan_blocks(x, params["blocks"], _ssm_body(cfg))
    elif cfg.family == "hybrid":
        x = _embed_tokens(cfg, params, tokens, None)
        x, aux = _hybrid_stack(cfg, x, params, positions)
    else:
        x = _embed_tokens(cfg, params, tokens, None)
        x, aux = _decoder_stack(cfg, x, params, positions)

    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_bias"))
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


def _decode_attn_block(cfg, x, p, kc, vc, pos):
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
    slot = slot.reshape(1).long()
    kc.index_copy_(1, slot, k.to(kc.dtype))
    vc.index_copy_(1, slot, v.to(vc.dtype))
    valid = torch.clamp(pos + 1, max=S) if cfg.sliding_window else pos + 1
    out = ll.decode_attention(q, kc, vc, valid)
    return x + out.reshape(B, 1, -1) @ p["wo"]


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, *, mesh=None) -> tuple:
    """tokens: (B, 1) -> (logits (B, 1, V), updated cache).

    The new token's k/v (and, for ssm / hybrid, each layer's state and
    conv tail) are written into the tensors of the cache it is given; the
    returned dict holds those same tensors and a new `pos`.  Clone a cache
    before this call to keep it."""
    _no_mesh(mesh)
    params = _cast_params(cfg, params)
    pos = cache["pos"]
    B = tokens.shape[0]
    x = params["embed"][tokens].to(_dtype(cfg.compute_dtype))
    if cfg.learned_positions:
        x = x + params["pos_embed"].index_select(
            0, pos.reshape(1).long())[None].to(x.dtype)
    new_cache = dict(cache)

    def ssm_layer(x, p, i):
        hn = ll.rms_norm(x, p["norm"])
        y, c2 = ssm_lib.ssd_decode_step(
            _ssm_params(p), hn,
            ssm_lib.SSMCache(cache["h"][i], cache["conv"][i]), ssm_dims(cfg))
        cache["h"][i].copy_(c2.h)
        cache["conv"][i].copy_(c2.conv)
        return x + y

    if cfg.family in ("dense", "moe", "vlm"):
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            x = _decode_attn_block(cfg, x, p, cache["k"][i], cache["v"][i],
                                   pos)
            x, _ = _mlp_block(cfg, x, p)

    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = ssm_layer(x, _layer(params["blocks"], i), i)

    elif cfg.family == "hybrid":
        shared = params["shared_attn"]
        app = 0
        for start, stop, attend in _hybrid_segments(cfg):
            for i in range(start, stop):
                x = ssm_layer(x, _layer(params["blocks"], i), i)
            if attend:
                x = _decode_attn_block(cfg, x, shared, cache["ak"][app],
                                       cache["av"][app], pos)
                x, _ = _mlp_block(cfg, x, shared)
                app += 1

    elif cfg.family == "audio":
        hd_ = cfg.resolved_head_dim
        for i in range(cfg.n_layers):
            p = _layer(params["dec_blocks"], i)
            x = _decode_attn_block(cfg, x, p, cache["k"][i], cache["v"][i],
                                   pos)
            xp = _cross(p)
            hq = _norm(cfg, x, xp["attn_norm"])
            q = (hq @ xp["wq"]).reshape(B, 1, cfg.n_heads, hd_)
            xk, xv = cache["xk"][i], cache["xv"][i]
            out = ll.decode_attention(q, xk, xv, xk.shape[1])
            x = x + out.reshape(B, 1, -1) @ xp["wo"]
            x, _ = _mlp_block(cfg, x, p)

    new_cache["pos"] = pos + 1
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_bias"))
    return _logits(cfg, params, x), new_cache


def _prefill_kv(cfg, hn, p, positions, B, S):
    hd = cfg.resolved_head_dim
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


def prefill(cfg: ModelConfig, params: Params, batch: dict,
            max_seq: int, mesh=None) -> tuple:
    """Full-sequence forward filling the serving cache.

    Returns (last-position logits, cache).  For vlm, batch carries
    frontend_embeds prepended to the token sequence (total length must be
    <= max_seq); for audio, frontend_embeds feed the encoder and the
    cross-attention KV is precomputed here.
    """
    _no_mesh(mesh)
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
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            hn = _norm(cfg, x, p["attn_norm"])
            k, v = _prefill_kv(cfg, hn, p, positions, B, St)
            ks.append(k)
            vs.append(v)
            x = _attn_block(cfg, x, p, positions)
            x, _ = _mlp_block(cfg, x, p)
        cache["k"] = _store_kv(cache["k"], torch.stack(ks), St)
        cache["v"] = _store_kv(cache["v"], torch.stack(vs), St)
        cache["pos"] = _pos_scalar(St, device)

    elif cfg.family in ("ssm", "hybrid"):
        x = _embed_tokens(cfg, params, tokens, None)
        positions = _positions(S, device)
        dims = ssm_dims(cfg)
        hs, convs, aks, avs = [], [], [], []

        def ssm_layers(x, start, stop):
            for i in range(start, stop):
                p = _layer(params["blocks"], i)
                hn = ll.rms_norm(x, p["norm"])
                y, c = ssm_lib.ssd_forward(_ssm_params(p), hn, dims,
                                           chunk=_eff_chunk(cfg, S),
                                           return_cache=True)
                x = x + y
                hs.append(c.h)
                convs.append(c.conv)
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
                    aks.append(k)
                    avs.append(v)
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
        for i in range(cfg.n_layers):
            p = _layer(params["dec_blocks"], i)
            hn = _norm(cfg, x, p["attn_norm"])
            k, v = _prefill_kv(cfg, hn, p, positions, B, S)
            x = _attn_block(cfg, x, p, positions)
            xp = _cross(p)
            xk, xv = _cross_kv(cfg, enc_out, xp)
            x = _attn_block(cfg, x, xp, None, kv_override=(xk, xv))
            x, _ = _mlp_block(cfg, x, p)
            for acc, t in zip((ks, vs, xks, xvs), (k, v, xk, xv)):
                acc.append(t)
        cache["k"] = _store_kv(cache["k"], torch.stack(ks), S)
        cache["v"] = _store_kv(cache["v"], torch.stack(vs), S)
        cache["xk"] = torch.stack(xks).to(cache["xk"].dtype)
        cache["xv"] = torch.stack(xvs).to(cache["xv"].dtype)
        cache["pos"] = _pos_scalar(S, device)
    else:
        raise ValueError(cfg.family)

    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_bias"))
    logits = _logits(cfg, params, x[:, -1:, :])
    return logits, cache
