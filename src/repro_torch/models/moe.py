"""Mixture-of-Experts FFN with gather/scatter dispatch: slot indices are
built with a scatter and tokens move by gather, so dispatch costs memory
traffic, not matrix products.

Token-choice top-k routing with per-group capacity (drops overflow, like
Switch/GShard), in the JAX package's order (`models/moe.py`): route,
scatter the slot table, gather-dispatch, grouped expert products,
gather-combine.  Expert weights carry a leading E axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor       # load-balance loss (Switch-style)
    drop_frac: torch.Tensor      # fraction of selections dropped


def stable_top_k(probs: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, ties to
    the lower index first, as `jax.lax.top_k` (a stable descending sort;
    `torch.topk` promises no order among ties)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_in: torch.Tensor, w_out: torch.Tensor, *, top_k: int,
            group_size: int = 1024, capacity_factor: float = 1.25
            ) -> tuple[torch.Tensor, MoEMetrics]:
    """x: (T, D) tokens -> (T, D).  Experts: w_* have leading E axis."""
    T, D = x.shape
    E = w_gate.shape[0]
    k = top_k
    G = max(1, T // group_size)
    S = T // G                                           # tokens per group
    C = max(k, int(S * k / E * capacity_factor))         # capacity per group

    xg = x.reshape(G, S, D)
    logits = xg.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                # (G, S, E)
    top_p, top_e = stable_top_k(probs, k)                # (G, S, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Position of each selection within its expert queue (per group):
    # rank via cumsum over the flattened (S*k) selection order.
    flat_e = top_e.reshape(G, S * k)
    sel_onehot = F.one_hot(flat_e, E).to(torch.int32)    # (G, S*k, E)
    pos = torch.cumsum(sel_onehot, dim=1, dtype=torch.int32) - sel_onehot
    pos = torch.gather(pos, 2, flat_e[:, :, None])[..., 0]   # (G, S*k)
    pos = pos.reshape(G, S, k)
    keep = pos < C                                       # (G, S, k) bool

    # Slot table: slot = e*C + pos; dropped selections target a trash slot.
    slot = torch.where(keep, top_e * C + pos, E * C)     # (G, S, k)
    src_token = torch.arange(S, device=x.device)[None, :, None].expand(
        G, S, k)
    # Scatter token ids into the slot table (one extra trash slot).  Kept
    # selections have distinct slots; only the trash slot E*C may be
    # written several times, in an order the scatter does not promise, and
    # it is cut off below, so the result does not depend on that order.
    table = torch.zeros((G, E * C + 1), dtype=torch.int64, device=x.device)
    table.scatter_(1, slot.reshape(G, S * k), src_token.reshape(G, S * k))
    src = table[:, :E * C]                               # (G, E*C)

    # Dispatch: gather token rows -> (G, E, C, D).
    xe = torch.gather(xg, 1, src[:, :, None].expand(G, E * C, D))
    xe = xe.reshape(G, E, C, D)

    # Expert FFN: grouped products (contraction per expert), f32 sums.
    xe32 = xe.float()
    h = torch.einsum("gecd,edf->gecf", xe32, w_gate.float())
    u = torch.einsum("gecd,edf->gecf", xe32, w_in.float())
    act = (F.silu(h) * u).to(x.dtype)
    ye = torch.einsum("gecf,efd->gecd", act.float(),
                      w_out.float()).to(x.dtype)

    # Combine: gather each selection's slot output, weight, sum over k.
    ye_flat = torch.cat([ye.reshape(G, E * C, D),
                         ye.new_zeros((G, 1, D))], dim=1)   # trash slot
    sel = torch.gather(ye_flat, 1, slot.reshape(G, S * k)[:, :, None]
                       .expand(G, S * k, D)).reshape(G, S, k, D)
    w = (top_p * keep).to(x.dtype)                       # (G, S, k)
    y = torch.einsum("gskd,gsk->gsd", sel, w)

    # Switch load-balance aux loss: E * sum_e f_e * p_e.
    frac_sel = F.one_hot(top_e, E).float().mean(dim=(0, 1, 2))
    mean_p = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_sel * mean_p)
    drop = 1.0 - keep.float().mean()
    return y.reshape(T, D), MoEMetrics(aux, drop)

