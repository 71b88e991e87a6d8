"""Histogram-based gradient boosting of oblivious decision trees.

The port's counterpart of `src/repro/core/boosting.py`.  Each boosting
iteration fits one oblivious tree:

  level d in 0..depth-1:
    hist[f, leaf, bin] <- segment-sum of (g, h) over (current leaf, bin)
    gain[f, b] = sum_leaf  G_l^2/(H_l+l2)  for left/right partitions
    the SAME (f*, b*) split is applied to every leaf  (oblivious)
    leaf |= [bins[:, f*] >= b*] << d

  leaf values: w_l = -lr * G_l / (H_l + l2)    (Newton step)

`fit` is a front end over `repro_torch.training.gbdt.GBDTTrainer`: the
float matrix is binarized once into a uint8 `QuantizedPool` (int32 bins
past 255 borders) and boosting runs the registered `histogram` op over
it, on the card unless the caller asks for the CPU.

Not ported yet (ROADMAP): `rsm < 1` and `ordered` boosting (both draw from
JAX's threefry stream; `GBDTTrainer` refuses them), and the seed float
trainer `fit_scan`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core import quantize

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class BoostingParams:
    n_trees: int = 100
    depth: int = 6
    learning_rate: float = 0.1
    l2_reg: float = 3.0
    max_bins: int = 64
    rsm: float = 1.0              # feature subsample per tree
    ordered: bool = False         # CatBoost-style ordered boosting
    seed: int = 0


def _gain_term(gs, hs, l2):
    return gs * gs / (hs + l2)


def fit(x: np.ndarray, y: np.ndarray, *, loss: losses_lib.Loss,
        params: BoostingParams,
        borders: Optional[torch.Tensor] = None,
        n_borders: Optional[torch.Tensor] = None,
        device: torch.device | str = "cuda", backend: str = "auto"):
    """Train a GBDT on raw float features -> (ensemble, history).

    Quantizes once on `device` into a uint8 pool (or int32 bins when the
    borders exceed the uint8 bin space) and boosts on that, with the JAX
    package's math and history."""
    # lazy import: training.gbdt imports this module for the shared math
    from repro_torch.training import gbdt as gbdt_lib

    x = np.asarray(x, np.float32)
    if borders is None:
        borders, n_borders = quantize.compute_borders(x, params.max_bins)
    trainer = gbdt_lib.GBDTTrainer(loss, params, device=device,
                                   backend=backend)
    dev_borders = torch.as_tensor(borders).to(trainer.device)
    xd = torch.as_tensor(x, device=trainer.device)
    if int(borders.shape[0]) <= quantize.MAX_BINS - 1:
        pool = quantize.quantize_pool(xd, dev_borders, backend=backend)
        return trainer.fit_pool(pool, y, borders=borders,
                                n_borders=n_borders)
    bins = quantize.binarize_matrix(xd, dev_borders, backend=backend)
    return trainer.fit_bins(bins, y, borders=borders, n_borders=n_borders)
