"""Step functions: eval / prefill / decode step factories, the port's
counterpart of the JAX package's `models/steps.py`.

`make_train_step` needs the optimizer (`training/optimizer.py`), which
comes with the LM trainer (ROADMAP A11b).
"""
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
