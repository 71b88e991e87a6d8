"""Functional GBDT prediction: one-shot shims over `core.predictor`.

The port's counterpart of `src/repro/core/predict.py`.  Each call builds a
throwaway plan (the model moved to the device and lowered every time), so
anything that predicts more than once per model should build the plan
once instead:

    from repro_torch.core.predictor import Predictor
    plan = Predictor.build(ensemble)          # on the card by default
    plan.raw(x); plan.proba(x); plan.classify(x)

The JAX package's `block_n` / `block_t` set the fused Pallas kernel's
blocks.  The port's plans pick a launch plan per shape
(`kernels.tuning.fused_plan`), so a caller that passes either gets a
`ValueError` saying so rather than having it ignored.  `predict_sharded`
and `shard_inputs` are not ported yet (ROADMAP A7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.predictor import (PredictConfig, Predictor, Strategy,
                                        classify_from_raw, proba_from_raw)
from repro_torch.core.trees import ObliviousEnsemble


def _one_shot(ensemble: ObliviousEnsemble, strategy: Strategy, backend: str,
              tree_block: int, block_n: Optional[int],
              block_t: Optional[int],
              device: torch.device | str) -> Predictor:
    if block_n is not None or block_t is not None:
        raise ValueError(
            f"block_n={block_n}, block_t={block_t}: the port's fused "
            "kernels pick their launch plan per shape "
            "(kernels.tuning.fused_plan) and take no block sizes; leave "
            "both None")
    return Predictor.build(
        ensemble, PredictConfig(strategy=strategy, backend=backend,
                                tree_block=tree_block), device=device)


def raw_predict(ensemble: ObliviousEnsemble, x, *,
                strategy: Strategy = "auto",
                backend: str = "auto",
                tree_block: int = 0,
                block_n: Optional[int] = None,
                block_t: Optional[int] = None,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """(N, F) float32, or a `QuantizedPool`, -> (N, C) float32 raw scores
    (tree sum + base score) on `device`; the pool path skips binarizing.
    Prefer `Predictor.build(...).raw(x)` (see the module docstring)."""
    plan = _one_shot(ensemble, strategy, backend, tree_block, block_n,
                     block_t, device)
    return plan.raw_uncached(x)


def predict_proba(ensemble: ObliviousEnsemble, x, **kw) -> torch.Tensor:
    """One-shot class probabilities; prefer `Predictor.build(...).proba`."""
    return proba_from_raw(raw_predict(ensemble, x, **kw),
                          ensemble.n_outputs)


def predict_class(ensemble: ObliviousEnsemble, x, **kw) -> torch.Tensor:
    """One-shot int32 class ids; prefer `Predictor.build(...).classify`."""
    return classify_from_raw(raw_predict(ensemble, x, **kw),
                             ensemble.n_outputs)
