"""Physical-layout selection for `PredictConfig(layout="auto")`.

The port's copy of the layout rule in `src/repro/kernels/tuning.py`: the
leaf-table and lowered-array byte costs of each layout, from the
ensemble's per-tree true depths, and the choice made from them.

On the CPU `best_layout` gives what the JAX package's gives for its
`ref` backend: depth_grouped when true depths mix and the per-depth leaf
tables save at least `GROUPED_MIN_SAVINGS` of the soa table, bitpacked
among those when the reference's (T, Dmax, F) f32 one-hot would pass
`REFERENCE_ONEHOT_LIMIT_BYTES`, soa otherwise.  The JAX package's other
branch (depth_major for its Pallas kernels while the one-hot stays under
`DEPTH_MAJOR_MAX_ONEHOT_BYTES`) and its 96 MiB budget are TPU quantities.
On CUDA `auto` stays soa for now: the rows per second of every layout at
the bulk shape and at the 1,024-row serving bucket, which `chip_smoke.py`
measures on the card, are the evidence a card rule is to be set from.
"""
from __future__ import annotations

import numpy as np
import torch

# depth_grouped pays one index + gather launch per group to shrink the
# leaf tables; it is worth that once the shallow trees save this share of
# the table padded to Dmax (and there is more than one group).
GROUPED_MIN_SAVINGS = 0.30
# The JAX package's ceiling on its lowered (T, D, F) f32 one-hot, under
# which its Pallas branch picks depth_major.  The CPU rule does not read
# it; it stays beside `layout_costs` for the card rule to be set against.
DEPTH_MAJOR_MAX_ONEHOT_BYTES = 8 * 1024 * 1024
# The JAX package's VMEM budget (`src/repro/kernels/tuning.py`
# VMEM_BUDGET): past it, its rule sends mixed-depth models to bitpacked.
# Kept only so the CPU choice equals the reference's.
REFERENCE_ONEHOT_LIMIT_BYTES = 96 * 1024 * 1024


def layout_costs(true_depths, n_outputs: int, n_features: int
                 ) -> dict[str, int]:
    """Leaf-table and lowered-array bytes per layout for an ensemble with
    the given per-tree true depths (the JAX package's keys and numbers;
    the one-hot is what its depth_major would lower, which the port's
    does not)."""
    d = np.asarray(true_depths, np.int64)
    dmax = int(d.max()) if d.size else 1
    soa_leaf = int(d.size) * (1 << dmax) * n_outputs * 4
    grouped_leaf = int(((1 << np.maximum(d, 1)) * n_outputs * 4).sum())
    onehot = int(d.size) * dmax * n_features * 4
    plane = int((2 * np.maximum(d, 1) * 4).sum())
    return {"soa_leaf_bytes": soa_leaf,
            "depth_grouped_leaf_bytes": grouped_leaf,
            "depth_major_onehot_bytes": onehot,
            "bitpacked_leaf_bytes": grouped_leaf,
            "bitpacked_plane_bytes": plane}


def best_layout(true_depths, n_outputs: int, n_features: int, *,
                device: torch.device | str = "cpu") -> str:
    """The layout `auto` lowers to on `device` (see the module docstring)."""
    d = np.asarray(true_depths, np.int64)
    if torch.device(device).type == "cuda" or d.size == 0:
        return "soa"
    costs = layout_costs(d, n_outputs, n_features)
    if len(set(d.tolist())) > 1:
        savings = 1.0 - (costs["depth_grouped_leaf_bytes"]
                         / max(costs["soa_leaf_bytes"], 1))
        if savings >= GROUPED_MIN_SAVINGS:
            if costs["depth_major_onehot_bytes"] > \
                    REFERENCE_ONEHOT_LIMIT_BYTES:
                return "bitpacked"
            return "depth_grouped"
    return "soa"
