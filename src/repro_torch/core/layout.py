"""Physical ensemble layout: the lowering step between Predictor plans and
kernels.

The port's counterpart of `src/repro/core/layout.py`, with the `soa`
layout only (the others are later slices).  A logical `ObliviousEnsemble`
is lowered once, at `Predictor.build`, into a `SoaLayout` whose arrays a
kernel family reads as they are.  Every kernel masks its own edges, so
lowering pads nothing: a CUDA plan and a CPU plan hold the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops

LAYOUT_NAMES = ("soa",)


@dataclasses.dataclass(frozen=True)
class SoaLayout:
    """Structure of arrays with one shared depth."""
    layout_name = "soa"
    borders: torch.Tensor           # (B, F) f32
    split_features: torch.Tensor    # (T, D) i32
    split_bins: torch.Tensor        # (T, D) i32
    leaf_values: torch.Tensor       # (T, L, C) f32
    n_outputs: int = 1

    def leaf_sum(self, bins: torch.Tensor, *, backend: str) -> torch.Tensor:
        """Staged leaf index + leaf gather from bins -> (N, C)."""
        idx = ops.leaf_index_prepadded(bins, self.split_features,
                                       self.split_bins, backend=backend)
        return ops.leaf_gather_prepadded(idx, self.leaf_values,
                                         backend=backend)

    def fused_raw(self, x: torch.Tensor, *, backend: str) -> torch.Tensor:
        return ops.fused_predict_prepadded(
            x, self.borders, self.split_features, self.split_bins,
            self.leaf_values, backend=backend)

    def leaf_table_bytes(self) -> int:
        return int(np.prod(self.leaf_values.shape)) * 4

    def describe(self) -> dict[str, Any]:
        return {"layout": self.layout_name,
                "leaf_table_bytes": self.leaf_table_bytes(),
                "trees": int(self.split_features.shape[0])}


def _check_structure(ensemble) -> None:
    """Model arrays arrive from outside the program (an `.npz`, a
    converter): check once what the kernels rely on per call."""
    t, d = ensemble.split_features.shape
    if ensemble.split_bins.shape != (t, d):
        raise ValueError(f"split_bins {tuple(ensemble.split_bins.shape)} "
                         f"does not match split_features {(t, d)}")
    if tuple(ensemble.leaf_values.shape[:2]) != (t, 1 << d):
        raise ValueError(f"leaf_values {tuple(ensemble.leaf_values.shape)} "
                         f"must be (T, 2^D, C) = ({t}, {1 << d}, C)")
    if t and d:
        sf = ensemble.split_features
        lo, hi = int(sf.min()), int(sf.max())
        if lo < 0 or hi >= ensemble.n_features:
            raise ValueError(f"split features span [{lo}, {hi}], outside "
                             f"the model's {ensemble.n_features} features")


def lower(ensemble, layout: str = "soa") -> SoaLayout:
    """Lower a logical `ObliviousEnsemble` into the `soa` layout."""
    if layout not in LAYOUT_NAMES:
        raise ValueError(f"unknown layout {layout!r}; the port has "
                         f"{LAYOUT_NAMES}")
    _check_structure(ensemble)
    return SoaLayout(ensemble.borders.contiguous(),
                     ensemble.split_features.contiguous(),
                     ensemble.split_bins.contiguous(),
                     ensemble.leaf_values.contiguous(),
                     n_outputs=ensemble.n_outputs)
