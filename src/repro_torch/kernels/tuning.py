"""Physical-layout selection for `PredictConfig(layout="auto")`, and the
shared-memory plan of the training histogram kernel.

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

import dataclasses

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


# --------------------------------------------------------------------------
# Training histogram plan (csrc/histogram.cu) on sm_90
# --------------------------------------------------------------------------
# The JAX package sizes its histogram grid against the TPU's 96 MiB VMEM
# (`src/repro/kernels/tuning.py` hist_footprint, VMEM_BUDGET): the one-hot
# selector panel it feeds the MXU.  The CUDA kernel builds no one-hot.  A
# block holds a tile of (leaf, bin) segments of one feature, every stat of
# each, as int64 fixed-point cells in shared memory, and the plan picks
# the tile and the row chunks.
SM_COUNT = 132                     # H100 SXM
SMEM_PER_SM = 228 * 1024           # shared memory of one SM
SMEM_OPTIN_LIMIT = 232_448         # the most one block may opt in to
SMEM_RESERVED_PER_BLOCK = 1024     # the runtime's own share of each block
HIST_CELL_BYTES = 8                # int64 fixed-point accumulator
HIST_MAX_STATS = 64                # csrc/histogram.cu kMaxStats (2C, C <= 32)
HIST_STATIC_BYTES = HIST_MAX_STATS * 8   # the per-stat double scales
# Two blocks an SM: each tile within half the SM, less the statics.
HIST_TILE_BYTES = (SMEM_PER_SM // 2 - SMEM_RESERVED_PER_BLOCK
                   - HIST_STATIC_BYTES)
HIST_BLOCKS_PER_SM = 4             # blocks in flight the row chunks aim at
HIST_MIN_CHUNK_ROWS = 2048         # rows a block scans at least


@dataclasses.dataclass(frozen=True)
class HistPlan:
    """The grid of one histogram launch: `n_tiles` tiles of `seg_tile`
    segments per feature, `row_chunks` chunks of rows, and the dynamic
    shared memory of a block (`tile_bytes`)."""
    seg_tile: int
    n_tiles: int
    row_chunks: int
    tile_bytes: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic plus static shared memory of one block."""
        return self.tile_bytes + HIST_STATIC_BYTES


def hist_plan(n_features: int, n_rows: int, n_leaves: int, n_bins: int,
              n_stats: int) -> HistPlan:
    """Tile the (leaf, bin) segment axis so one tile of int64 cells fits
    `HIST_TILE_BYTES`, in tiles of equal size; then cut the rows into
    chunks until there are `HIST_BLOCKS_PER_SM` blocks an SM, but no chunk
    under `HIST_MIN_CHUNK_ROWS` rows.

    At Covertype width (54 features, 64 bins, 14 stats) a tile holds up
    to 1,028 segments: one tile a feature at d <= 4, 8 at d = 7, each of
    at most 114,688 bytes."""
    if not 1 <= n_stats <= HIST_MAX_STATS:
        raise ValueError(f"the histogram kernel takes 1..{HIST_MAX_STATS} "
                         f"stats (2C for C <= 32 outputs), got {n_stats}")
    n_segs = max(n_leaves * n_bins, 1)
    fit = HIST_TILE_BYTES // (n_stats * HIST_CELL_BYTES)
    n_tiles = -(-n_segs // fit)
    seg_tile = -(-n_segs // n_tiles)
    target = HIST_BLOCKS_PER_SM * SM_COUNT
    chunks = -(-target // max(n_features * n_tiles, 1))
    chunks = max(1, min(chunks, -(-n_rows // HIST_MIN_CHUNK_ROWS)))
    return HistPlan(seg_tile, n_tiles, chunks,
                    seg_tile * n_stats * HIST_CELL_BYTES)
