"""Shared LM building blocks: norms, RoPE, attention (GQA/SWA/chunked),
MLPs.  Pure functions on tensors over explicit parameter dicts; the
dtype policy is the JAX package's (`models/layers.py`): parameters stored
in `param_dtype`, compute in `compute_dtype`, softmax and norms in f32.

Where JAX asks XLA for an f32 product of low-precision operands
(`preferred_element_type=jnp.float32`), the product here is taken on f32
copies of the operands: a bf16 x bf16 product is exact in f32, so this is
JAX's f32 accumulation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, Dh), positions: (B, S) or (S,)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (half,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]                      # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:2 * half].float()
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if x.shape[-1] > 2 * half:                               # odd tail passes
        rot = torch.cat([rot, x[..., 2 * half:].float()], dim=-1)
    return rot.to(dt)


def sinusoidal_positions(seq: int, dim: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def _attend_block(q, k, v, mask):
    """q: (B, Sq, KVH, G, Dh); k/v: (B, Sk, KVH, Dh); mask: (Sq, Sk) or None.

    f32 scores and softmax; the value product on the probabilities cast to
    v's dtype, accumulated in f32.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhgd,bshd->bhgqs", q.float(), k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[None, None, None, :, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _mask(sq: int, sk: int, q_off: int, *, causal: bool, window: int,
          device: torch.device | str = "cpu") -> torch.Tensor:
    """(sq, sk) boolean mask. q position = q_off + row."""
    qpos = q_off + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_chunk: int = 0
              ) -> torch.Tensor:
    """GQA attention.  q: (B, S, H, Dh), k/v: (B, S, KVH, Dh).

    `q_chunk > 0` enables row-blocked execution: exact softmax per query
    block, O(S * q_chunk) score memory instead of O(S^2).
    """
    B, S, H, Dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, Dh)

    if q_chunk and S > q_chunk and S % q_chunk == 0:
        outs = []
        for off in range(0, S, q_chunk):
            m = (_mask(q_chunk, k.shape[1], off, causal=causal,
                       window=window, device=q.device)
                 if (causal or window) else None)
            outs.append(_attend_block(qg[:, off:off + q_chunk], k, v, m))
        out = torch.cat(outs, dim=1)
    else:
        m = _mask(S, S, 0, causal=causal, window=window,
                  device=q.device) if (causal or window) else None
        out = _attend_block(qg, k, v, m)
    return out.reshape(B, S, H, Dh)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos, *, window: int = 0
                     ) -> torch.Tensor:
    """One-token attention over a (possibly longer-than-valid) KV cache.

    q: (B, 1, H, Dh); caches: (B, S, KVH, Dh); cur_pos: an int or a 0-d
    integer tensor on the caches' device — the number of valid cache
    positions (the new token's k/v already written).
    """
    B, _, H, Dh = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, 1, KVH, G, Dh)
    scale = Dh ** -0.5
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.float(),
                          k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)[None, None, None, None, :]
    valid = kpos < cur_pos
    if window > 0:
        valid = valid & (kpos > cur_pos - 1 - window)
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_in)
    return h @ w_out


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out
