"""Carry a model across from the JAX package.

`ensemble_from_numpy` takes the JAX ensemble's fields as numpy arrays
(`{k: np.asarray(v)}` over `split_features`, `split_bins`, `leaf_values`,
`borders`, `n_borders` and optionally `base_score`);
`ensemble_from_jax_npz` reads the `.npz` its `ObliviousEnsemble.save`
writes.  Both give an `ObliviousEnsemble` on the CPU.
"""
from __future__ import annotations

import pathlib
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.trees import ObliviousEnsemble

FIELDS = ("split_features", "split_bins", "leaf_values", "borders",
          "n_borders", "base_score")


def ensemble_from_numpy(arrays: Mapping[str, np.ndarray]
                        ) -> ObliviousEnsemble:
    unknown = set(arrays) - set(FIELDS)
    if unknown:
        raise ValueError(f"unknown ensemble fields {sorted(unknown)}; "
                         f"expected {FIELDS}")
    return ObliviousEnsemble(**{k: torch.from_numpy(np.array(v))
                                for k, v in arrays.items()})


def ensemble_from_jax_npz(path: str | pathlib.Path) -> ObliviousEnsemble:
    return ObliviousEnsemble.load(path)
