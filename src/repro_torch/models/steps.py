"""Step functions: train / eval / prefill / decode step factories, the
port's counterpart of the JAX package's `models/steps.py`."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf

AUX_WEIGHT = 0.01     # MoE load-balance loss weight


def token_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor
               ) -> torch.Tensor:
    """Mean next-token cross entropy; logits (B, S, V) fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def loss_fn(cfg: ModelConfig, params, batch, mesh=None
            ) -> tuple[torch.Tensor, dict]:
    logits, aux = tf.forward(cfg, params, batch, mesh=mesh)
    ce = token_loss(cfg, logits, batch["labels"])
    total = ce + AUX_WEIGHT * aux
    return total, {"ce": ce, "aux": aux}


def make_train_step(cfg: ModelConfig, optimizer, mesh=None) -> Callable:
    """Returns fn(params, opt_state, batch) -> (params, opt_state, metrics).

    The gradient is `torch.autograd.grad` of `loss_fn` over the floating
    leaves; `optimizer` follows `repro_torch.training.optimizer` (its
    `update` runs with ``inplace=True``), and each parameter becomes
    ``p + u.to(p.dtype)``.  The step updates `params` and `opt_state` in
    place and returns them: JAX's trainer donates both, so no caller reads
    the old values (clone them first to keep them).  `metrics` holds
    `loss`, `ce`, `aux` and `grad_norm` as 0-d tensors on the parameters'
    device; nothing in the step waits for the device.
    """
    def train_step(params, opt_state, batch):
        paths = [path for path, leaf in tf.tree_leaves(params)
                 if leaf.is_floating_point()]
        flat = dict(tf.tree_leaves(params))
        with torch.enable_grad():
            diff = {path: flat[path].detach().requires_grad_()
                    for path in paths}
            loss, parts = loss_fn(cfg, tf.unflatten({**flat, **diff}),
                                  batch, mesh=mesh)
            grads = torch.autograd.grad(loss, [diff[p] for p in paths])
        del diff
        grads = tf.unflatten(dict(zip(paths, grads)))
        with torch.no_grad():
            gnorm = optimizer.global_norm(grads)
            updates, opt_state = optimizer.update(grads, opt_state, params,
                                                  inplace=True)
            del grads
            for path, u in tf.tree_leaves(updates):
                p = flat[path]
                p.add_(u.to(p.dtype))
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": torch.as_tensor(parts["aux"]).detach(),
                   "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    def eval_step(params, batch):
        loss, parts = loss_fn(cfg, params, batch)
        return {"loss": loss, **parts}
    return eval_step


def make_prefill_step(cfg: ModelConfig, max_seq: int,
                      mesh=None) -> Callable:
    def prefill_step(params, batch):
        return tf.prefill(cfg, params, batch, max_seq, mesh=mesh)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None) -> Callable:
    def decode_step(params, cache, tokens):
        return tf.decode_step(cfg, params, cache, tokens, mesh=mesh)
    return decode_step
