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
# block holds a tile of (leaf, bin) segments of one or more features,
# every stat of each, as int64 fixed-point cells in shared memory, and the
# plan picks the tile, the features a block and the row chunks.
SM_COUNT = 132                     # H100 SXM
SMEM_PER_SM = 228 * 1024           # shared memory of one SM
SMEM_OPTIN_LIMIT = 232_448         # the most one block may opt in to
SMEM_RESERVED_PER_BLOCK = 1024     # the runtime's own share of each block
HIST_CELL_BYTES = 8                # int64 fixed point, as two 32-bit words
HIST_MAX_STATS = 64                # csrc/histogram.cu kMaxStats (2C, C <= 32)
HIST_THREADS = 1024                # csrc/histogram.cu kHistThreads
# The per-stat double scales and inverse scales, and each warp's 32-byte
# row order.
HIST_STATIC_BYTES = 2 * HIST_MAX_STATS * 8 + (HIST_THREADS // 32) * 32
# One block an SM, with as much shared memory as a block may have: a
# block's cells are every int64 of its tile.
HIST_TILE_BYTES = min(SMEM_OPTIN_LIMIT,
                      SMEM_PER_SM - SMEM_RESERVED_PER_BLOCK) \
    - HIST_STATIC_BYTES
HIST_MAX_FEATS_PER_BLOCK = 8       # csrc/histogram.cu kMaxFeatsPerBlock
HIST_MIN_CHUNK_ROWS = 4096         # rows a chunked block scans at least
# Where a feature's segments take several tiles, a tile is a run of
# leaves, and a trained tree's rows crowd into a few leaves: the blocks of
# those tiles would take the most time.  Row chunks up to this many waves
# (2 a tile, at most) spread them.
HIST_BALANCE_WAVES = 8
GRID_DIM_LIMIT = 65_535            # largest gridDim.y and gridDim.z
# A row's own work in a block (loading and scaling its stats, ranking
# it), in units of the adds of one feature: the plan's weight for the
# share of a block's work that more features a block save.
HIST_ROW_COST = 2.0


@dataclasses.dataclass(frozen=True)
class HistPlan:
    """The grid of one histogram launch: `feats_per_block` features a
    block in `n_groups` groups, `n_tiles` tiles of `seg_tile` (leaf, bin)
    segments per group (`tile_bytes` of cells per feature), and
    `row_chunks` chunks of rows.  With one chunk a block rounds its own
    cells into the output (`direct`); otherwise the chunks meet in an int64
    buffer."""
    seg_tile: int
    n_tiles: int
    row_chunks: int
    tile_bytes: int
    feats_per_block: int
    n_groups: int

    @property
    def block_bytes(self) -> int:
        """Dynamic shared memory of one block: its features' tiles."""
        return self.feats_per_block * self.tile_bytes

    @property
    def smem_bytes(self) -> int:
        """Dynamic plus static shared memory of one block."""
        return self.block_bytes + HIST_STATIC_BYTES

    @property
    def n_blocks(self) -> int:
        return self.n_groups * self.n_tiles * self.row_chunks

    @property
    def waves(self) -> int:
        """Rounds of one block an SM the launch takes."""
        return -(-self.n_blocks // SM_COUNT)

    @property
    def direct(self) -> bool:
        return self.row_chunks == 1


def _hist_grid(n_features: int, n_rows: int, n_segs: int, n_stats: int,
               feats: int) -> HistPlan:
    """The plan with `feats` features a block: the fewest tiles that fit
    HIST_TILE_BYTES; then, if that is less than a wave, row chunks up to
    one wave (none under HIST_MIN_CHUNK_ROWS rows), else more, smaller
    tiles to fill the last wave."""
    groups = -(-n_features // feats)
    fit = HIST_TILE_BYTES // (feats * n_stats * HIST_CELL_BYTES)
    tiles = -(-n_segs // fit)
    chunks = 1
    if groups * tiles >= SM_COUNT:
        waves = -(-groups * tiles // SM_COUNT)
        tiles = min(n_segs, max(tiles, waves * SM_COUNT // groups))
    else:
        max_chunks = max(1, n_rows // HIST_MIN_CHUNK_ROWS)
        chunks = max(1, min(max_chunks, SM_COUNT // (groups * tiles)))
    seg_tile = -(-n_segs // tiles)
    tiles = -(-n_segs // seg_tile)
    return HistPlan(seg_tile, tiles, chunks,
                    seg_tile * n_stats * HIST_CELL_BYTES, feats, groups)


def hist_plan(n_features: int, n_rows: int, n_leaves: int, n_bins: int,
              n_stats: int) -> HistPlan:
    """The histogram launch's plan: for each count of features a block
    (1..`HIST_MAX_FEATS_PER_BLOCK`) the grid `_hist_grid` gives; of those
    that fit one wave, the one with the most blocks weighted by the share
    of a row's work that is adds (fpb / (fpb + HIST_ROW_COST)); if none
    fits, the most features.  Then, where a feature takes several tiles,
    row chunks up to HIST_BALANCE_WAVES waves.

    At Covertype width (54 features, 325,360 rows, 64 bins, 14 stats), by
    depth d = 0..7: 8, 8, 8, 8, 7, 8, 8, 8 features a block; 1, 1, 1, 2,
    4, 8, 16, 37 tiles; 18, 18, 18, 38, 33, 19, 10, 5 chunks.  At the kNN
    head (533 features, 2,808 rows, 64 bins, 40 stats), by depth d = 0..3:
    5, 5, 8, 8 features a block; 1, 1, 3, 7 tiles; one chunk (every block
    writes its output directly)."""
    if not 1 <= n_stats <= HIST_MAX_STATS:
        raise ValueError(f"the histogram kernel takes 1..{HIST_MAX_STATS} "
                         f"stats (2C for C <= 32 outputs), got {n_stats}")
    n_segs = max(n_leaves * n_bins, 1)
    n_features = max(n_features, 1)
    plans = [_hist_grid(n_features, n_rows, n_segs, n_stats, feats)
             for feats in range(min(HIST_MAX_FEATS_PER_BLOCK, n_features),
                                0, -1)]
    one_wave = [p for p in plans if p.waves == 1]
    plan = max(one_wave, key=lambda p: p.n_blocks * p.feats_per_block
               / (p.feats_per_block + HIST_ROW_COST)) if one_wave else plans[0]
    if plan.n_tiles > 1:
        waves = min(HIST_BALANCE_WAVES, 2 * plan.n_tiles)
        chunks = min(max(1, n_rows // HIST_MIN_CHUNK_ROWS),
                     -(-waves * SM_COUNT // (plan.n_groups * plan.n_tiles)))
        plan = dataclasses.replace(plan,
                                   row_chunks=max(plan.row_chunks, chunks))
    return plan
