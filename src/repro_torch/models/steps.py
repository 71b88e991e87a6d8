"""Step functions: train / eval / prefill / decode step factories, the
port's counterpart of the JAX package's `models/steps.py`."""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models import transformer as tf

AUX_WEIGHT = 0.01     # MoE load-balance loss weight


def token_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor
               ) -> torch.Tensor:
    """Mean next-token cross entropy; logits (B, S, V) fp32."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        # explicit redistribution: DTensor would all-reduce the pending
        # sums inside `logsumexp`, leaving every shard of that mesh
        # dimension the whole (B, S, V) block
        logits = layers.settle(logits)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - _gold(logits, labels))


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels]: a `torch.gather` over the vocabulary, or, on
    vocab-sharded DTensor logits, each shard's gather of the labels that
    fall in its slice (0 elsewhere) summed over the shards.

    Explicit redistribution: DTensor's own gather of a vocab-sharded
    dimension gives a masked partial it cannot reduce; this is that
    reduction, an all-reduce of (B, S) values over the vocabulary's mesh
    dimensions, and no shard ever holds the whole vocabulary."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    mesh, vdim = logits.device_mesh, logits.ndim - 1
    vocab_dims = [i for i, p in enumerate(logits.placements)
                  if p.is_shard(vdim)]
    rest = [Replicate() if i in vocab_dims else p
            for i, p in enumerate(logits.placements)]
    labels = labels.redistribute(mesh, rest) if isinstance(
        labels, DTensor) else distribute_tensor(labels, mesh, rest,
                                                src_data_rank=None)
    _, offset = layers.local_shape_and_offset(logits.shape, mesh,
                                              logits.placements)
    local = logits.to_local()
    idx = labels.to_local().long() - offset[vdim]
    inside = (idx >= 0) & (idx < local.shape[-1])
    picked = torch.gather(local, -1, idx.clamp(0, local.shape[-1] - 1)
                          [..., None])[..., 0]
    picked = torch.where(inside, picked, torch.zeros_like(picked))
    return layers.from_local(picked, mesh, [
        Partial() if i in vocab_dims else p for i, p in enumerate(rest)],
        labels.shape)


def aux_weight(cfg: ModelConfig) -> float:
    """The balance loss's weight: the configuration's own `aux_alpha`
    where it states one, else AUX_WEIGHT."""
    return getattr(cfg, "aux_alpha", AUX_WEIGHT)


def loss_fn(cfg: ModelConfig, params, batch, mesh=None
            ) -> tuple[torch.Tensor, dict]:
    """(total loss, parts): `ce`, `aux` and whatever the forward hands a
    step beside them (`transformer.forward`'s `stats`)."""
    stats: dict = {}
    logits, aux = tf.forward(cfg, params, batch, mesh=mesh, stats=stats)
    ce = token_loss(cfg, logits, batch["labels"])
    total = ce + aux_weight(cfg) * aux
    return total, {"ce": ce, "aux": aux, **stats}


def make_train_step(cfg: ModelConfig, optimizer, mesh=None) -> Callable:
    """Returns fn(params, opt_state, batch) -> (params, opt_state, metrics).

    The gradient is `torch.autograd.grad` of `loss_fn` over the floating
    leaves; `optimizer` follows `repro_torch.training.optimizer` (its
    `update` runs with ``inplace=True``), and each parameter becomes
    ``p + u.to(p.dtype)``.  The step updates `params` and `opt_state` in
    place and returns them: JAX's trainer donates both, so no caller reads
    the old values (clone them first to keep them).  `metrics` holds
    `loss`, `ce`, `aux` and `grad_norm` as 0-d tensors on the parameters'
    device; nothing in the step waits for the device but mla_moe's MoE
    layers, each once for its held experts' loads (`moe.hold`).

    Buffers (`transformer.is_buffer`: DeepSeek-V3's routing correction
    bias) get no gradient and no optimizer update; after the update each
    moves by its own rule (`transformer.update_buffers`) on what the
    forward handed the step, and `metrics` adds each 0-d tensor among
    those (mla_moe: `held_selections`).

    On DTensor parameters (the sharded trainer) the same step runs under
    `implicit_replication` (tensors the model makes, masks and positions,
    count as replicated): each gradient is reduced onto its parameter's
    placements (DTensor leaves it as a pending sum over the shards that
    share it: the data-parallel all-reduce, or reduce-scatter where the
    parameter is sharded) before the norm and the update, and each
    metric is replicated and handed back as this rank's plain 0-d tensor,
    the same on every rank.
    """
    def train_step(params, opt_state, batch):
        paths = [path for path, leaf in tf.tree_leaves(params)
                 if leaf.is_floating_point() and not tf.is_buffer(path)]
        flat = dict(tf.tree_leaves(params))
        sharded = any(isinstance(v, DTensor) for v in flat.values())
        with _replicating(params):
            with torch.enable_grad():
                diff = {path: flat[path].detach().requires_grad_()
                        for path in paths}
                loss, parts = loss_fn(cfg, tf.unflatten({**flat, **diff}),
                                      batch, mesh=mesh)
                grads = torch.autograd.grad(loss, [diff[p] for p in paths])
            del diff
            if sharded:
                grads = [_like(g, flat[p]) for g, p in zip(grads, paths)]
            grads = tf.unflatten(dict(zip(paths, grads)))
            with torch.no_grad():
                gnorm = optimizer.global_norm(grads)
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params, inplace=True)
                del grads
                for path, u in tf.tree_leaves(updates):
                    p = flat[path]
                    p.add_(_like(u, p).to(p.dtype))
                tf.update_buffers(cfg, flat, parts)
            metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                       "aux": torch.as_tensor(parts["aux"]).detach(),
                       "grad_norm": gnorm}
            metrics.update({k: v.detach() for k, v in parts.items()
                            if k not in metrics and v.dim() == 0})
            if sharded:
                metrics = {k: _replicated(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step


def _like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """DTensor `x` on `ref`'s placements (a pending sum reduced)."""
    if isinstance(x, DTensor) and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def _replicated(x: torch.Tensor) -> torch.Tensor:
    """A 0-d metric as this rank's plain tensor of its replicated value."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim).to_local()


def make_eval_step(cfg: ModelConfig) -> Callable:
    def eval_step(params, batch):
        loss, parts = loss_fn(cfg, params, batch)
        return {"loss": loss, **parts}
    return eval_step


def _replicating(params):
    """`implicit_replication` on DTensor parameters (the tensors the model
    makes count as replicated), else nothing."""
    sharded = any(isinstance(v, DTensor) for _, v in tf.tree_leaves(params))
    return implicit_replication() if sharded else contextlib.nullcontext()


def make_prefill_step(cfg: ModelConfig, max_seq: int,
                      mesh=None) -> Callable:
    """fn(params, batch) -> (last-position logits, cache); on DTensor
    parameters the cache comes back placed by `sharding.cache_specs`."""
    def prefill_step(params, batch):
        with _replicating(params):
            return tf.prefill(cfg, params, batch, max_seq, mesh=mesh)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None) -> Callable:
    """fn(params, cache, tokens) -> (logits, cache), writing the cache it
    is given (`transformer.decode_step`)."""
    def decode_step(params, cache, tokens):
        with _replicating(params):
            return tf.decode_step(cfg, params, cache, tokens, mesh=mesh)
    return decode_step
