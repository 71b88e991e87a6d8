"""Mixture-of-Experts FFN with gather/scatter dispatch: slot indices are
built with a scatter and tokens move by gather, so dispatch costs memory
traffic, not matrix products.

Token-choice top-k routing with per-group capacity (drops overflow, like
Switch/GShard), in the JAX package's order (`models/moe.py`): route,
scatter the slot table, gather-dispatch, grouped expert products,
gather-combine.  Expert weights carry a leading E axis.

Beside it, for the mla_moe family, DeepSeek-V3's mixture as one card of
an expert-parallel layer runs it: sigmoid routing with a correction bias
over every expert (`sigmoid_route`), the selections of the experts held
here sorted by expert (`hold`) and computed without drops through one
grouped product a matrix (`routed_held_ffn`), and the bias rule applied
after a step (`update_bias`).
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.layers import from_local, regroup
from repro_torch.obs.trace import get_tracer

_TRACER = get_tracer()


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


def _dim_plan(p, q, gather_a: bool) -> tuple:
    """One mesh dim of `_expert_product`: from a's placement `p` and w's
    `q`, the placements of a and w for the local product, of its result,
    and of a's and w's local gradients."""
    r = Replicate()
    if p.is_shard(1) or (q == Shard(0) and not p.is_shard(0)):
        # a's experts, or w's where a holds them all (a slice of a)
        return Shard(1), Shard(0), Shard(1), Shard(1), Shard(0)
    if p.is_shard(0) and not (gather_a and q in (Shard(1), Shard(2))):
        # a's groups against the whole w: w's gradient a sum over them
        return p, r, p, p, Partial()
    if q == Shard(2):
        # w's y shard against the whole a: a's gradient a sum over them
        return r, q, Shard(3), Partial(), q
    if q == Shard(1):
        # w's x shard against a's (a slice of a): the result a sum
        return Shard(3), q, Partial(), Shard(3), q
    return r, r, r, r, r


def _expert_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("gecx,exy->gecy", a, w)``; on a DTensor `a`, shard by
    shard, each mesh dim by `_dim_plan`: w keeps its own shard (experts,
    x or y) wherever a is not sharded on g or e, and the result is
    sharded (or a pending sum) to match.  Where a is sharded on g and w
    on x or y, the smaller of the two is gathered: w (its gradient then
    a sum over the g shards), or a, so that expert2d's weights stay
    sharded where the activations are the smaller.

    Explicit redistribution: DTensor's einsum reshapes its permuted
    operand (and the backward its gradient) as a view of the local shard,
    whose layout can differ from the one DTensor records for the whole
    tensor after a redistribution, so the view fails (kimi-k2 at the
    production mesh, `launch/dryrun.py`)."""
    if not isinstance(a, DTensor):
        return torch.einsum("gecx,exy->gecy", a, w)
    mesh = a.device_mesh
    wp = w.placements if isinstance(w, DTensor) else [Replicate()] * \
        mesh.ndim

    # the blocks either would gather: a's as cut to w's experts, and w's;
    # from global shapes, so that every rank takes the same plan
    a_block = a.numel() // math.prod(
        mesh.size(i) for i, (p, q) in enumerate(zip(a.placements, wp))
        if p.is_shard() or q == Shard(0))
    w_block = w.numel() // math.prod(
        mesh.size(i) for i, q in enumerate(wp) if q.is_shard())
    gather_a = a_block < w_block
    a_at, w_at, out_at, a_grad, w_grad = map(list, zip(*(
        _dim_plan(p, q, gather_a) for p, q in zip(a.placements, wp))))
    w = w.redistribute(mesh, w_at) if isinstance(w, DTensor) else \
        distribute_tensor(w, mesh, w_at, src_data_rank=None)
    out = torch.einsum("gecx,exy->gecy",
                       a.redistribute(mesh, a_at).to_local(
                           grad_placements=a_grad),
                       w.to_local(grad_placements=w_grad))
    return from_local(out.contiguous(), mesh, out_at,
                      (*a.shape[:3], w.shape[-1]))


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

    xg = regroup(x, (G, S, D))
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
    table = slot.new_zeros((G, E * C + 1), dtype=torch.int64)
    table.scatter_(1, slot.reshape(G, S * k), src_token.reshape(G, S * k))
    src = table[:, :E * C]                               # (G, E*C)

    # Dispatch: gather token rows -> (G, E, C, D).
    xe = torch.gather(xg, 1, src[:, :, None].expand(G, E * C, D))
    xe = xe.reshape(G, E, C, D)

    # Expert FFN: grouped products (contraction per expert), f32 sums.
    xe32 = xe.float()
    h = _expert_product(xe32, w_gate.float())
    u = _expert_product(xe32, w_in.float())
    act = (F.silu(h) * u).to(x.dtype)
    ye = _expert_product(act.float(), w_out.float()).to(x.dtype)

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
    return regroup(y, (T, D)), MoEMetrics(aux, drop)



# --------------------------------------------------------------------------
# DeepSeek-V3 routing over every expert, dropless over the experts held
# --------------------------------------------------------------------------
class SigmoidRoute(NamedTuple):
    experts: torch.Tensor        # (T, k) int64, chosen over all E experts
    weights: torch.Tensor        # (T, k) f32, normalised and scaled
    aux_loss: torch.Tensor       # sequence-wise balance loss (unweighted)
    load: torch.Tensor           # (E,) int64: selections of each expert


def sigmoid_route(x: torch.Tensor, router_w: torch.Tensor,
                  bias: torch.Tensor, *, top_k: int, scaling: float,
                  n_seqs: int) -> SigmoidRoute:
    """DeepSeek-V3's `noaux_tc` gate with one group: sigmoid scores of
    the f32 logits x @ router_w (x: (T, D), router_w: (D, E)), the top-k
    of scores + `bias` (the correction bias, outside the gradient; ties
    to the lower index), weights the chosen scores normalised over the k
    and times `scaling`.  The balance loss is DeepSeek-V3's sequence-wise
    one over the T = n_seqs x S tokens: per sequence, sum over experts of
    f_i P_i, f_i = E / (k S) x the sequence's selections of i, P_i the
    mean over its tokens of the scores normalised over all E; the mean
    over the sequences."""
    T, E = x.shape[0], router_w.shape[-1]
    scores = torch.sigmoid(x.float() @ router_w.float())          # (T, E)
    _, experts = stable_top_k(scores + bias.detach().float()[None], top_k)
    chosen = torch.gather(scores, 1, experts)
    weights = chosen / (chosen.sum(-1, keepdim=True) + 1e-20) * scaling
    load = torch.bincount(experts.reshape(-1), minlength=E)
    S = T // n_seqs
    picked = torch.zeros(n_seqs, E, device=x.device).scatter_add_(
        1, experts.reshape(n_seqs, S * top_k),
        torch.ones(n_seqs, S * top_k, device=x.device))
    f = picked * (E / (top_k * S))
    p = (scores / scores.sum(-1, keepdim=True)).reshape(n_seqs, S, E)
    aux = (f * p.mean(1)).sum(-1).mean()
    return SigmoidRoute(experts, weights, aux, load)


def grouped_product(x: torch.Tensor, w: torch.Tensor, rows: list[int]
                    ) -> torch.Tensor:
    """Rows of x (n, X), sorted by expert, each times its expert's
    w[e] (G, X, Y): one `torch._grouped_mm` over the G experts, `rows[e]`
    rows each (CUTLASS's grouped GEMM on the card: bfloat16 operands, f32
    sums).  No rows at all: an empty product, which keeps w in the graph
    with a zero gradient.  Never a loop over experts."""
    if x.is_cuda and x.dtype != torch.bfloat16:
        raise ValueError(f"torch._grouped_mm takes bfloat16 operands on "
                         f"the card, not {x.dtype}")
    if not sum(rows):
        return x @ w[0]
    offs = torch.tensor(list(itertools.accumulate(rows)), dtype=torch.int32,
                        device=x.device)
    return torch._grouped_mm(x, w, offs=offs)


class Held(NamedTuple):
    selections: torch.Tensor     # (n,) the held selections (t * k + j),
    #                              sorted by held expert
    tokens: torch.Tensor         # (n,) each one's token
    rows: list[int]              # each held expert's selections
    chosen: int                  # the route's selections of held experts


def hold(route: SigmoidRoute, offset: int, n_held: int) -> Held:
    """The selections of experts offset .. offset + n_held - 1 (the ones
    held here), sorted by expert, in token order within one: every one of
    them (dropless).  Reading the rows, with the route's own count of the
    held experts' selections (`route.load`, what `chosen` keeps), is the
    layer's one wait for the card."""
    k = route.experts.shape[1]
    local = route.experts.reshape(-1) - offset
    key = torch.where((local >= 0) & (local < n_held), local,
                      torch.full_like(local, n_held))
    order = torch.argsort(key, stable=True)
    counts = torch.cat([torch.bincount(key, minlength=n_held + 1)[:n_held],
                        route.load[offset:offset + n_held]]).tolist()
    rows = counts[:n_held]
    sel = order[:sum(rows)]
    return Held(sel, sel // k, rows, sum(counts[n_held:]))


def routed_held_ffn(x: torch.Tensor, route: SigmoidRoute, held: Held,
                    w_gate: torch.Tensor, w_in: torch.Tensor,
                    w_out: torch.Tensor) -> torch.Tensor:
    """The part of a routed SwiGLU mixture that the experts held here give,
    for the tokens x (T, D): each of `held`'s selections through its
    expert's w_gate / w_in (G, D, F) and w_out (G, F, D), one grouped
    product a matrix, times its routing weight, summed onto its token in
    f32.  Selections of experts not held here add nothing (another card's
    share)."""
    T, D = x.shape
    xs = x[held.tokens]
    with _TRACER.span("dispatch/expert_product", "kernel", device=x.device,
                      rows=held.rows, D=D, F=w_gate.shape[-1],
                      dtype=str(x.dtype)):
        h = grouped_product(xs, w_gate, held.rows)
        u = grouped_product(xs, w_in, held.rows)
        ys = grouped_product(F.silu(h) * u, w_out, held.rows)
    ys = ys.float() * route.weights.reshape(-1)[held.selections, None]
    y = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    return y.index_add_(0, held.tokens, ys).to(x.dtype)


def update_bias(bias: torch.Tensor, load: torch.Tensor, speed: float
                ) -> None:
    """DeepSeek-V3's auxiliary-loss-free balancing, in place after a step:
    each expert's correction bias moves by `speed` towards the mean load,
    bias += speed x sign(mean load - load), over all the router's experts
    (load: their selections in the step)."""
    load = load.float()
    bias.add_(speed * torch.sign(load.mean(-1, keepdim=True) - load))
