"""Mamba2 (SSD — state-space duality) block, chunked scan formulation.

The SSD algorithm of arXiv:2405.21060, in the JAX package's order
(`models/ssm.py`): the sequence is split into chunks; within a chunk the
recurrence is a masked, decay-weighted quadratic product, like attention;
across chunks a scan carries the (H, N, P) state, here a Python loop.

Decode is the pure recurrence: h <- exp(dt*A) h + dt * (x outer B);
y = h . C — O(1) per token.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


class SSMParams(NamedTuple):
    in_proj: torch.Tensor      # (D, 2*d_inner + 2*N + H)
    conv_w: torch.Tensor       # (W, conv_dim)  depthwise, conv_dim=d_inner+2N
    conv_b: torch.Tensor       # (conv_dim,)
    A_log: torch.Tensor        # (H,)
    D_skip: torch.Tensor       # (H,)
    dt_bias: torch.Tensor      # (H,)
    norm_scale: torch.Tensor   # (d_inner,)
    out_proj: torch.Tensor     # (d_inner, D)


def ssm_dims(d_model: int, *, expand: int = 2, headdim: int = 64,
             d_state: int = 64, conv_width: int = 4):
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_dim = d_inner + 2 * d_state
    return dict(d_inner=d_inner, n_heads=n_heads, headdim=headdim,
                d_state=d_state, conv_dim=conv_dim, conv_width=conv_width)


def log_linspace(H: int) -> torch.Tensor:
    """log(linspace(1, 16, H)) in f32 on the CPU, by JAX's linspace formula
    (start * (1 - step) + stop * step, step = i / (H - 1)).  XLA compiles
    that formula and `log` with its own f32 arithmetic, so an entry may
    differ from the JAX package's `A_log` in its last bit."""
    if H == 1:
        return torch.zeros((1,))
    step = torch.arange(H - 1, dtype=torch.float32) / (H - 1)
    return torch.log(torch.cat([1.0 * (1 - step) + 16.0 * step,
                                torch.tensor([16.0])]))


def init_ssm_params(generator: torch.Generator, d_model: int, dims: dict,
                    dtype=torch.float32, device: torch.device | str = "cpu"
                    ) -> SSMParams:
    """Random projections from `generator` (drawn on its device); the
    deterministic leaves equal the JAX package's."""
    d_inner, H = dims["d_inner"], dims["n_heads"]
    N, W, conv_dim = dims["d_state"], dims["conv_width"], dims["conv_dim"]
    proj_out = 2 * d_inner + 2 * N + H

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device)
        return x.mul_(scale).to(device=device, dtype=dtype)

    return SSMParams(
        in_proj=normal((d_model, proj_out), 0.02),
        conv_w=normal((W, conv_dim), 0.2),
        conv_b=torch.zeros((conv_dim,), dtype=dtype, device=device),
        A_log=log_linspace(H).to(device=device, dtype=dtype),
        D_skip=torch.ones((H,), dtype=dtype, device=device),
        dt_bias=torch.full((H,), -1.0, dtype=dtype, device=device),
        norm_scale=torch.ones((d_inner,), dtype=dtype, device=device),
        out_proj=normal((d_inner, d_model), 0.02),
    )


def _depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C), w: (W, C). Causal depthwise conv, silu activation."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(W))
    return F.silu(out + b[None, None, :])


def _split_proj(zxbcdt, dims):
    d_inner, N = dims["d_inner"], dims["d_state"]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, xBC, dt


def ssd_forward(params: SSMParams, u: torch.Tensor, dims: dict, *,
                chunk: int = 64, return_cache: bool = False):
    """u: (B, S, D) -> (B, S, D) [, final SSMCache for decode handoff].

    S is padded up to a multiple of `chunk` internally (causal, so the
    tail padding never influences real positions).  The final state of a
    padded sequence would be advanced past S, so `return_cache` needs
    S % chunk == 0, as in the JAX package."""
    B, S0, D = u.shape
    if S0 % chunk:
        if return_cache:
            raise ValueError(f"return_cache requires S % chunk == 0 (S = "
                             f"{S0}, chunk = {chunk})")
        pad = chunk - S0 % chunk
        out = ssd_forward(params, F.pad(u, (0, 0, 0, pad)), dims,
                          chunk=chunk)
        return out[:, :S0, :]
    S = S0
    d_inner, H, P = dims["d_inner"], dims["n_heads"], dims["headdim"]
    N = dims["d_state"]
    W = dims["conv_width"]

    zxbcdt = u @ params.in_proj
    z, xBC, dt = _split_proj(zxbcdt, dims)
    xBC_raw = xBC                                          # pre-conv tail
    xBC = _depthwise_causal_conv(xBC, params.conv_w, params.conv_b)
    x = xBC[..., :d_inner].reshape(B, S, H, P)
    Bm = xBC[..., d_inner:d_inner + N]                     # (B, S, N)
    Cm = xBC[..., d_inner + N:]                            # (B, S, N)
    dt = F.softplus(dt.float() + params.dt_bias.float())   # (B, S, H)
    A = -torch.exp(params.A_log.float())                   # (H,)
    dA = dt * A[None, None, :]                             # (B, S, H) <= 0

    nc = S // chunk
    Q = chunk
    xc = x.reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)
    dtc = dt.reshape(B, nc, Q, H)
    dAc = dA.reshape(B, nc, Q, H)
    cs = torch.cumsum(dAc, dim=2)                          # (B, nc, Q, H)

    # ---- intra-chunk (quadratic, attention-like) ----
    CB = torch.einsum("bcqn,bcsn->bcqs", Cc.float(), Bc.float())
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device)
                     )[None, None, :, :, None]
    delta = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    # mask before exp: the upper triangle has delta > 0 (cs decreasing)
    decay = torch.exp(delta.masked_fill(~tri, -torch.inf))
    att = CB[:, :, :, :, None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", att.to(x.dtype).float(),
                           xc.float())

    # ---- chunk states ----
    last = cs[:, :, -1:, :]                                 # (B, nc, 1, H)
    w_state = torch.exp(last - cs) * dtc                    # (B, nc, Q, H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc.float(), w_state,
                          xc.float())                       # (B,nc,H,N,P)

    # ---- inter-chunk scan ----
    chunk_decay = torch.exp(last[:, :, 0, :])               # (B, nc, H)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=u.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                     # (B, nc, H, N, P)

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc.float(),
                           torch.exp(cs), h_prev)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + params.D_skip[None, None, :, None].float() * x.float()
    y = y.reshape(B, S, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), params.norm_scale)
    out = y @ params.out_proj
    if return_cache:
        conv_tail = xBC_raw[:, S - (W - 1):, :]
        return out, SSMCache(h=h, conv=conv_tail)
    return out


class SSMCache(NamedTuple):
    h: torch.Tensor          # (B, H, N, P) float32
    conv: torch.Tensor       # (B, W-1, conv_dim)


def init_ssm_cache(batch: int, dims: dict, dtype=torch.float32,
                   device: torch.device | str = "cpu") -> SSMCache:
    H, N, P = dims["n_heads"], dims["d_state"], dims["headdim"]
    W, conv_dim = dims["conv_width"], dims["conv_dim"]
    return SSMCache(
        h=torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, W - 1, conv_dim), dtype=dtype,
                         device=device))


def ssd_decode_step(params: SSMParams, u: torch.Tensor, cache: SSMCache,
                    dims: dict) -> tuple[torch.Tensor, SSMCache]:
    """u: (B, 1, D) one token -> (B, 1, D), updated cache (new tensors;
    the given cache is not written)."""
    B = u.shape[0]
    d_inner, H, P = dims["d_inner"], dims["n_heads"], dims["headdim"]
    N = dims["d_state"]

    zxbcdt = u[:, 0, :] @ params.in_proj                    # (B, total)
    z, xBC, dt = _split_proj(zxbcdt, dims)
    conv_in = torch.cat([cache.conv, xBC[:, None, :]], dim=1)
    conv_out = torch.sum(conv_in * params.conv_w[None, :, :], dim=1) \
        + params.conv_b[None, :]
    xBC = F.silu(conv_out)                                  # (B, conv_dim)
    x = xBC[:, :d_inner].reshape(B, H, P)
    Bm = xBC[:, d_inner:d_inner + N]
    Cm = xBC[:, d_inner + N:]
    dt = F.softplus(dt.float() + params.dt_bias.float())    # (B, H)
    A = -torch.exp(params.A_log.float())
    dA = torch.exp(dt * A[None, :])                         # (B, H)

    hx = cache.h * dA[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bm.float(), dt, x.float())
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), hx)
    y = y + params.D_skip[None, :, None].float() * x.float()
    y = y.reshape(B, d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), params.norm_scale)
    out = (y @ params.out_proj)[:, None, :]
    return out, SSMCache(h=hx, conv=conv_in[:, 1:, :])
