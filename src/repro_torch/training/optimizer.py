"""Optimizers: AdamW, Adafactor, SGD over the LM parameter dict.

The port's counterpart of `src/repro/training/optimizer.py`, with its
defaults, state keys and arithmetic:

    opt = adamw(lr=...);  state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = {p + u.to(p.dtype) for each leaf}

`update` is functional: it returns new state tensors and leaves the
ones it was given as they were.  With ``inplace=True`` it writes the new
moments into the state's own tensors instead (the returned state holds
those same tensors and a new `count`): the train step does that, since
JAX's trainer donates the optimizer state and never reads the old one.

The schedule, the bias corrections (``b ** count`` with an f32 count) and
the clip scale are f32 tensors on the state's device, as JAX computes
them; `global_norm` sums the leaves' squares in JAX's flattening order.

On DTensor leaves (the sharded trainer) the same code runs shard by
shard: the state takes each parameter's placements (Adafactor's `vr` /
`vc` those of the dims they keep, as `sharding.opt_state_specs` has
them), `count` and the scalars are replicated, and each sum over a
sharded dim (`global_norm`, Adafactor's means and RMS) is reduced over
the shards by DTensor.  Plain tensors beside DTensors (a constant rate)
need `torch.distributed.tensor.experimental.implicit_replication`, which
the train step enters.

Adafactor exists because 1T-param models (kimi-k2) cannot afford Adam's
two f32 moments: the second moment is factored into row and column
statistics (O(n + m) per matrix instead of O(nm)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.models.transformer import tree_leaves

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _pick(out, i: int):
    """Item `i` of each leaf's (update, state...) tuple."""
    return _map(lambda o: o[i], out)


def _lr_at(lr: Schedule, count: torch.Tensor) -> torch.Tensor:
    return (lr(count) if callable(lr)
            else torch.tensor(lr, dtype=torch.float32, device=count.device))


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """Linear warmup to `peak` over `warmup` steps, then a cosine down to
    `floor * peak` at `total`; f32 throughout, as JAX's."""
    def sched(count: torch.Tensor) -> torch.Tensor:
        count = count.float()
        warm = peak * count / max(warmup, 1)
        frac = torch.clamp((count - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + torch.cos(math.pi * frac)))
        return torch.where(count < warmup, warm, cos)
    return sched


def global_norm(tree) -> torch.Tensor:
    """sqrt of the f32 sum of every leaf's squares, leaf by leaf in JAX's
    flattening order."""
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2)
                          for _, leaf in tree_leaves(tree)))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    kind: str
    global_norm: Callable = global_norm


def _zeros(p: torch.Tensor, shape, keep=None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Zeros of `shape` on p's device.  For a DTensor `p` a DTensor on its
    mesh: ``keep[i]`` is the dim of the new tensor that p's dim i
    becomes (None: reduced away, its shards replicated); by default the
    dims are p's own."""
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    keep = list(range(p.ndim)) if keep is None else keep
    out = [Shard(keep[pl.dim]) if pl.is_shard()
           and keep[pl.dim] is not None else Replicate()
           for pl in p.placements]
    return dtensor_zeros(shape, dtype=dtype, device_mesh=p.device_mesh,
                         placements=out)


def _zeros_like_f32(p: torch.Tensor) -> torch.Tensor:
    return _zeros(p, p.shape)


def _count0(params) -> torch.Tensor:
    return _zeros(next(tree_leaves(params))[1], (), [], torch.int32)


def _store(old: torch.Tensor, new: torch.Tensor, inplace: bool
           ) -> torch.Tensor:
    """`new`, written into `old` with ``inplace``; a DTensor keeps `old`'s
    placements."""
    if isinstance(old, DTensor) and old.placements != new.placements:
        new = new.redistribute(old.device_mesh, old.placements)
    return old.copy_(new) if inplace else new


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
def adamw(lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": _map(_zeros_like_f32, params),
                "v": _map(_zeros_like_f32, params),
                "count": _count0(params)}

    def update(grads, state, params, *, inplace: bool = False):
        count = state["count"] + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
                 if clip_norm else 1.0)
        lr_t = _lr_at(lr, count)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def upd(g, m, v, p):
            g = g.float() * scale
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            mhat = m2 / c1
            vhat = v2 / c2
            step = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                            + weight_decay * p.float())
            return step, _store(m, m2, inplace), _store(v, v2, inplace)

        out = _map(upd, grads, state["m"], state["v"], params)
        return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                               "count": count}

    return Optimizer(init=init, update=update, kind="adamw")


# --------------------------------------------------------------------------
# Adafactor (factored second moment, no f32 master copies)
# --------------------------------------------------------------------------
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(lr: Schedule = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def vr(p):
            if not _factored(p.shape):
                return _zeros(p, p.shape)
            n = p.ndim
            return _zeros(p, p.shape[:-1], [*range(n - 1), None])

        def vc(p):
            if not _factored(p.shape):
                return _zeros(p, (0,), [None] * p.ndim)
            n = p.ndim
            return _zeros(p, p.shape[:-2] + p.shape[-1:],
                          [*range(n - 2), None, n - 2])

        return {"vr": _map(vr, params), "vc": _map(vc, params),
                "count": _count0(params)}

    def update(grads, state, params, *, inplace: bool = False):
        count = state["count"] + 1
        beta = 1.0 - count.float() ** -decay
        lr_t = _lr_at(lr, count)

        def upd(g, vr, vc, p):
            g = g.float()
            g2 = g * g + eps
            if _factored(g.shape):
                vr2 = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
                vc2 = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.sqrt(
                    vr2[..., None] * vc2[..., None, :]
                    / torch.clamp(torch.mean(vr2, dim=-1, keepdim=True)
                                  [..., None], min=eps))
            else:
                vr2 = beta * vr + (1 - beta) * g2
                vc2 = vc
                denom = torch.sqrt(vr2)
            u = g / torch.clamp(denom, min=eps)
            # RMS clipping (Adafactor's update clipping)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            step = -lr_t * (u + weight_decay * p.float())
            return (step, _store(vr, vr2, inplace),
                    vc2 if vc2 is vc else _store(vc, vc2, inplace))

        out = _map(upd, grads, state["vr"], state["vc"], params)
        return _pick(out, 0), {"vr": _pick(out, 1), "vc": _pick(out, 2),
                               "count": count}

    return Optimizer(init=init, update=update, kind="adafactor")


def sgd(lr: Schedule = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": _map(_zeros_like_f32, params),
                "count": _count0(params)}

    def update(grads, state, params, *, inplace: bool = False):
        count = state["count"] + 1
        lr_t = _lr_at(lr, count)

        def upd(g, m):
            m2 = momentum * m + g.float()
            return -lr_t * m2, _store(m, m2, inplace)

        out = _map(upd, grads, state["m"])
        return _pick(out, 0), {"m": _pick(out, 1), "count": count}

    return Optimizer(init=init, update=update, kind="sgd")


def make(cfg, total_steps: int = 10000, peak_lr: float = 3e-4) -> Optimizer:
    """JAX's `make`: warmup over min(1000, total // 10) steps then cosine;
    Adafactor where the config asks for it, else AdamW with weight decay
    0.1."""
    sched = warmup_cosine(peak_lr, min(1000, total_steps // 10), total_steps)
    if cfg.optimizer == "adafactor":
        return adafactor(lr=sched)
    return adamw(lr=sched, weight_decay=0.1)
