"""Physical-layout selection for `PredictConfig(layout="auto")`, the bulk
scorer's chunk shape (`best_chunk_rows`) and prefetch depth, and the
launch plans of the CUDA kernels: shared-memory tiles and their route,
output slabs, the leaf-index, leaf-gather and bitpacked-index grids, the
training histogram's grid and stat groups, and the distance matrix's
ring and tiles.  Every plan is plain Python, so the CPU tests check it at any
shape.

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
# Bulk-scoring chunk planner (`scoring.BulkScorer`)
# --------------------------------------------------------------------------
# The bytes one in-flight chunk may hold, on the host and the card together
# (`chunk_row_bytes`), and the clamp on the chunk's rows: the JAX package's
# constants (`src/repro/kernels/tuning.py`).  A chunk is a round trip of
# the host's Python and a handful of launches, so the chunk is the largest
# power of two whose working set fits.
CHUNK_BUDGET_BYTES = 32 * 1024 * 1024
MIN_CHUNK_ROWS = 256
MAX_CHUNK_ROWS = 1 << 17
# The smallest chunk at which the prefetch worker pays on the card: below
# it the thread hand-off and the side stream's event wait cost about what
# the overlap saves, or more (`scripts/bulk_probe.py` on an H100, three
# plans of the 1,000-tree Covertype model on uint8 pools, depth 2 against
# depth 0: 1.15-1.22 M rows/s against 1.51-1.71 M at 4,096 rows in one
# run; 1.90-2.13 M against 2.21-2.22 M at 16,384 rows and 2.36-2.81 M
# against 2.07-2.31 M at 65,536 in another).
PREFETCH_MIN_CHUNK_ROWS = 1 << 16


def chunk_row_bytes(n_features: int, n_outputs: int, *,
                    n_borders: int = 0, n_trees: int = 0,
                    n_leaves: int = 0) -> int:
    """Bytes one row of a scoring chunk costs in what the port allocates.

    The float32 row (the source's read and its pinned copy on the host,
    the chunk on the card), its uint8 bins (the pool), the (N, T) int32
    leaf-index panel the pool route writes (the fused route writes none)
    and the float32 output row.  The JAX package counts the (F, B)
    binarize comparison panel and the (T, L) gather one-hot of its staged
    code instead, float32 a row; the port's kernels build neither (at the
    smoke's 1,000-tree Covertype model: 4,298 bytes a row, where JAX's
    count gives 1,037,906 and pins the chunk at `MIN_CHUNK_ROWS`).
    `n_borders` and `n_leaves` count nothing here: they keep the JAX
    signature."""
    return (4 * n_features + n_features + 4 * n_trees
            + 4 * max(n_outputs, 2))


def best_chunk_rows(n_features: int, n_outputs: int, *,
                    n_borders: int = 0, n_trees: int = 0,
                    n_leaves: int = 0,
                    budget_bytes: int = CHUNK_BUDGET_BYTES,
                    n_rows: int | None = None) -> int:
    """The bulk scorer's fixed chunk shape: the largest power-of-two row
    count whose working set (`chunk_row_bytes`) fits the budget (pow2 so
    the tail's bucket ladder divides it), clamped to [MIN_CHUNK_ROWS,
    MAX_CHUNK_ROWS].  A known `n_rows` caps the chunk at the first power
    of two that covers the whole dataset.  `n_borders` and `n_leaves`
    keep the JAX signature and change nothing."""
    per_row = chunk_row_bytes(n_features, n_outputs, n_trees=n_trees)
    rows = MIN_CHUNK_ROWS
    while rows * 2 <= MAX_CHUNK_ROWS and rows * 2 * per_row <= budget_bytes:
        rows *= 2
    if n_rows is not None and n_rows > 0:
        cover = MIN_CHUNK_ROWS
        while cover < n_rows:
            cover *= 2
        rows = min(rows, cover)
    return rows


def prefetch_depth(depth: int, chunk_rows: int, n_chunks: int,
                   on_card: bool) -> int:
    """How many chunks the bulk scorer's prefetch worker runs ahead: the
    configured `depth`, or 0 (no worker thread) for a single chunk, and
    on the card for chunks under PREFETCH_MIN_CHUNK_ROWS, where the
    synchronous path is faster."""
    if n_chunks < 2 or (on_card and chunk_rows < PREFETCH_MIN_CHUNK_ROWS):
        return 0
    return depth


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
HIST_MAX_STATS = 64                # csrc/histogram.cu kMaxStats: one launch
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
    buffer.  `stat_groups` are the [start, stop) slices of the stats, one
    launch each, at most HIST_MAX_STATS wide; the grid is planned for the
    widest."""
    seg_tile: int
    n_tiles: int
    row_chunks: int
    tile_bytes: int
    feats_per_block: int
    n_groups: int
    stat_groups: tuple[tuple[int, int], ...] = ((0, 1),)

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


def slices(n: int, width: int) -> tuple[tuple[int, int], ...]:
    """[start, stop) slices cutting range(n) into the fewest pieces of at
    most `width`, each ceil(n / pieces) long but the last (66 at width
    64: 33 + 33; 33 at width 32: 17 + 16).  The kernels cut their output
    slabs the same way."""
    pieces = max(1, -(-n // width))
    step = max(1, -(-n // pieces))
    return tuple((i * step, min(n, (i + 1) * step)) for i in range(pieces))


def stat_groups(n_stats: int) -> tuple[tuple[int, int], ...]:
    """The histogram's stat groups: one launch each."""
    return slices(n_stats, HIST_MAX_STATS)


def hist_plan(n_features: int, n_rows: int, n_leaves: int, n_bins: int,
              n_stats: int) -> HistPlan:
    """The histogram launch's plan: past HIST_MAX_STATS stats, one launch
    a stat group (`stat_groups`: the fixed-point scale is per stat, so a
    group's cells are the whole's, bit for bit), each with the grid below
    planned for the widest group.  The grid: for each count of features a block
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
    if n_stats < 1:
        raise ValueError(f"the histogram takes at least one stat, got "
                         f"{n_stats}")
    groups = stat_groups(n_stats)
    n_stats = max(stop - start for start, stop in groups)
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
    return dataclasses.replace(plan, stat_groups=groups)


# --------------------------------------------------------------------------
# Shared-memory tiles of bins, and their route
# --------------------------------------------------------------------------
# The index and fused kernels stage a block's rows of bins in shared
# memory.  A tile that fits the 48 KB a block has by default is staged
# there; past that the kernel opts in to up to SMEM_OPTIN_LIMIT (as
# csrc/binarize.cu does for its border table); a row too wide for even
# the fewest rows there is read from global memory (`route` "global"),
# by the same kernel under a template flag.
SMEM_DEFAULT_BYTES = 48 * 1024


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """`rows` rows a block; a staged row holds `stride` bins (n_features
    on the global route); `tile_bytes` of dynamic shared memory for the
    tile beside the kernel's `static_bytes` of other shared memory."""
    rows: int
    stride: int
    route: str
    tile_bytes: int
    static_bytes: int

    @property
    def smem_bytes(self) -> int:
        return self.tile_bytes + self.static_bytes

    @property
    def opt_in(self) -> bool:
        """Whether the block needs more than the default 48 KB."""
        return self.smem_bytes > SMEM_DEFAULT_BYTES


def _tile(n_features: int, bin_bytes: int, *, max_rows: int, granule: int,
          static_bytes: int, odd_stride: bool,
          budgets: tuple[int, ...] = (SMEM_DEFAULT_BYTES, SMEM_OPTIN_LIMIT)
          ) -> TilePlan:
    """As many rows as fit the first of `budgets` (the default 48 KB, then
    the opt-in limit) that holds any, at most `max_rows`, in multiples of
    `granule`; the global route if not even `granule` rows fit."""
    if odd_stride:
        words = (n_features * bin_bytes + 3) // 4 | 1
        stride = words * 4 // bin_bytes
    else:
        stride = n_features
    row_bytes = max(stride * bin_bytes, 1)
    for budget in budgets:
        rows = min(max_rows,
                   (budget - static_bytes) // row_bytes // granule * granule)
        if rows >= granule:
            return TilePlan(rows, stride, "shared", rows * row_bytes,
                            static_bytes)
    return TilePlan(max_rows, n_features, "global", 0, static_bytes)


def strided_tile(n_features: int, bin_bytes: int, static_bytes: int,
                 max_rows: int, warp: int = 32) -> TilePlan:
    """A bins tile whose rows a warp reads one row a lane: the stride is
    an odd number of 4-byte words, so the 32 rows read at one feature sit
    in 32 distinct shared-memory banks.  Rows come in whole warps."""
    return _tile(n_features, bin_bytes, max_rows=max_rows, granule=warp,
                 static_bytes=static_bytes, odd_stride=True)


# The fused kernels: one thread a row, up to 128 rows (4 warps) a block.
# The depth-major and bitpacked ones stage a chunk of trees' (D, T) planes
# in 16 KB of static shared memory (csrc/fused_planes.cuh: 2,048 entries a
# plane) beside the level weights.
FUSED_MAX_ROWS = 128
PLANE_BYTES = 16 * 1024 + 4 * 16


def tile_shape(n_features: int, u8: bool, planes: bool = False) -> TilePlan:
    """The bins tile of a fused kernel (`planes`: the dm and bp ones).  On
    the global route stage 1 writes the bins to an (N, F) scratch array."""
    return strided_tile(n_features, 1 if u8 else 4,
                        PLANE_BYTES if planes else 0, FUSED_MAX_ROWS)


# --------------------------------------------------------------------------
# Output slabs
# --------------------------------------------------------------------------
# A thread of a gather or fused kernel sums at most this many outputs of
# a row at a time; more outputs go in slabs, each summed over the trees
# in tree order, so every (row, output) is one add a tree in tree order
# at any C.
SLAB_OUTPUTS = 32


def output_slabs(n_outputs: int) -> tuple[tuple[int, int], ...]:
    return slices(n_outputs, SLAB_OUTPUTS)


# --------------------------------------------------------------------------
# csrc/leaf_gather.cu
# --------------------------------------------------------------------------
# Lanes of a warp hold a row's outputs (`lanes`, the slab's width rounded
# up to a power of two), so a warp sums 32 / lanes rows at once.  Staged:
# one 1,024-thread block an SM stages a chunk of trees' leaf values (one
# slab) and its rows' idx for those trees in shared memory, and sums many
# rows a thread against each chunk.  Direct: a row a lane group, leaf
# values read from L2 with 8 trees' loads in flight.
GATHER_STAGED_THREADS = 1024
GATHER_STAGE_BYTES = SMEM_OPTIN_LIMIT
GATHER_MAX_CHUNK = 32              # trees a chunk: a warp's lanes load idx
GATHER_MIN_STAGE_TREES = 4         # trees a chunk holds at least
GATHER_MAX_ROWS_PER_THREAD = 16    # csrc/leaf_gather.cu kMaxRows
GATHER_DIRECT_THREADS = (64, 256)  # a direct block's threads, least, most
SECTOR_BYTES = 32                  # what a direct gather pulls from L2


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """`n_slabs` slabs of `slab` outputs (the last may be narrower), each
    summed by `lanes` lanes a row; `threads` a block, each summing
    `rows_per_thread` rows; staged blocks hold `trees_per_chunk` trees'
    leaf values and idx (`smem_bytes`).  The grid is (n_row_blocks,
    n_slabs)."""
    slab: int
    n_slabs: int
    lanes: int
    staged: bool
    threads: int
    rows_per_thread: int
    trees_per_chunk: int
    n_row_blocks: int
    smem_bytes: int

    @property
    def rows_per_block(self) -> int:
        return self.threads // self.lanes * self.rows_per_thread


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _pow2_at_most(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def gather_stage_bytes(trees: int, n_leaves: int, slab: int,
                       rows: int) -> int:
    """Shared memory of a staged chunk: the trees' leaf values of a slab,
    padded to 16 bytes, then `rows` rows of idx, each padded to whole
    16-byte words (csrc/leaf_gather.cu sizes it the same way)."""
    return (-(-trees * n_leaves * slab * 4 // 16) * 16
            + rows * -(-trees // 4) * 16)


def gather_plan(n_rows: int, n_trees: int, n_leaves: int, n_outputs: int,
                staged: bool | None = None) -> GatherPlan:
    """The leaf-gather launch.  `staged=None` picks: stage when a chunk of
    GATHER_MIN_STAGE_TREES trees fits (a model of fewer trees reads
    directly) and the rows of each SM's block are at least n_leaves *
    slab * 4 / SECTOR_BYTES (the bytes a block stages a tree, from L2, are
    no more than the sectors its rows' direct gathers would pull).  At
    depth 8, C = 7 that is 224 rows: the 139,440-row bulk call stages
    (1,152 rows a block, 19 trees a chunk), a 1,024-row bucket reads
    directly."""
    spans = output_slabs(max(n_outputs, 1))
    slab = spans[0][1] - spans[0][0]
    n_slabs = len(spans)
    lanes = _pow2_at_least(slab)
    slots = GATHER_STAGED_THREADS // lanes
    n_leaves = max(n_leaves, 1)
    per_sm = -(-n_rows // max(1, SM_COUNT // n_slabs))
    rpt = min(GATHER_MAX_ROWS_PER_THREAD, max(1, -(-per_sm // slots)))
    rows = slots * rpt
    chunk = next((t for t in range(min(GATHER_MAX_CHUNK, max(n_trees, 1)),
                                   0, -1)
                  if gather_stage_bytes(t, n_leaves, slab, rows)
                  <= GATHER_STAGE_BYTES), 0)
    if staged is None:
        staged = (chunk >= GATHER_MIN_STAGE_TREES
                  and per_sm * SECTOR_BYTES >= n_leaves * slab * 4)
    if staged:
        if chunk < 1:
            raise ValueError(f"{n_leaves} leaves x {slab} outputs leave no "
                             f"room for a tree in {GATHER_STAGE_BYTES} "
                             "bytes of shared memory")
        return GatherPlan(slab, n_slabs, lanes, True, GATHER_STAGED_THREADS,
                          rpt, chunk, max(1, -(-n_rows // rows)),
                          gather_stage_bytes(chunk, n_leaves, slab, rows))
    least, most = GATHER_DIRECT_THREADS
    threads = min(most, max(least, _pow2_at_most(
        n_rows * lanes * n_slabs // SM_COUNT)))
    return GatherPlan(slab, n_slabs, lanes, False, threads, 1, 0,
                      max(1, -(-n_rows // (threads // lanes))), 0)


# --------------------------------------------------------------------------
# csrc/fused_predict.cu (soa), csrc/fused_predict_dm.cu (depth_major) and
# csrc/fused_predict_bp.cu (bitpacked, one depth group)
# --------------------------------------------------------------------------
# Two routes each.  `row`: one thread a row walks every tree (tile_shape's
# bins tile, FUSED_MAX_ROWS rows a block; csrc/fused_planes.cuh for dm and
# bp).  `spread` (csrc/fused_spread.cuh, one source for all three): a
# block of a few rows binarizes them into shared memory, then walks the
# trees in chunks; its threads compute the (row, tree) indexes of a chunk,
# gather the chunk's leaf values into a shared buffer with asynchronous
# copies, and lanes over (row, output) add them in tree order while the
# next chunk's copies are in flight.  A serving bucket then fills the
# card: N // SM_COUNT rows a block.  The dm and bp spread blocks stage a
# chunk's splits from their (D, T) planes into the same shared layout
# (bp's uint8 thresholds widened to int32); dm holds its level weights in
# SPREAD_WEIGHT_BYTES of static shared memory, bp has none.  Threads and
# pairs a chunk were set from scripts/fused_route_sweep.py on the H100
# (PERF.md §6): 512 threads beat 256 by 23-31% at the kNN head's 533
# features and lose up to 6% at Covertype's 54.
SPREAD_THREADS = 512               # csrc/fused_spread.cuh kSpreadMaxThreads
SPREAD_MAX_BLOCK_ROWS = 32         # rows a spread block binarizes at most
SPREAD_PAIRS = 1024                # (row, tree) pairs a chunk, at most
SPREAD_MAX_ACC = 4                 # csrc/fused_spread.cuh kSpreadMaxAcc
# Rows up to which the plan takes the spread route: the row route's
# 128-row blocks fill the 132 SMs from 16,896 rows on, and the sweep found
# spread faster up to 16,384 rows on both shapes, slower at the kNN head
# from 32,768 and on both at 139,440.
SPREAD_MAX_ROWS = 16_384
# The dm kernel's: its row route is slower than soa's at the kNN head, and
# the sweep with `--layout depth_major` found spread faster up to 32,768
# rows on both shapes, at parity at 40,960 on Covertype's and slower from
# 49,152 there (PERF.md §6).
SPREAD_MAX_ROWS_DM = 32_768
# The bp kernel's: the sweep with `--layout bitpacked` found spread faster
# up to 32,768 rows on Covertype's shape (device ms 0.765 against the row
# route's 0.909) and slower from 40,960 (0.961 against 0.915), as dm's;
# at the kNN head's it wins to 65,536 (PERF.md §6).
SPREAD_MAX_ROWS_BP = 32_768
SPREAD_SMEM_LIMIT = SMEM_OPTIN_LIMIT - SMEM_RESERVED_PER_BLOCK
SPREAD_WEIGHT_BYTES = 4 * 16       # the dm kernel's kMaxDepth int32 weights


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def spread_pitch(chunk: int, slab: int) -> int:
    """Words of one row's leaf values in a spread buffer: the chunk's
    trees times the slab, padded to slab (mod 32) so that the lanes of a
    warp, summing consecutive (row, output) pairs at one tree, read 32
    distinct banks."""
    words = chunk * slab
    return words + (slab - words) % 32


def spread_smem_bytes(rows: int, chunk: int, slab: int, depth: int,
                      n_features: int, bin_bytes: int) -> int:
    """Dynamic shared memory of a spread block, as csrc/fused_spread.cuh
    lays it out: two leaf-value buffers, the chunk's (row, tree) indexes,
    its (D, chunk) plane of (split feature, split bin) pairs, the bins
    tile."""
    return (2 * _align16(rows * spread_pitch(chunk, slab) * 4)
            + _align16(rows * chunk * 4) + _align16(2 * depth * chunk * 4)
            + _align16(rows * n_features * bin_bytes))


# Where a fused kernel's splits come from, csrc/fused_spread.cuh's Splits:
# soa's (T, D) rows, dm's (D, T) planes with level weights, bp's planes.
SPLITS = ("rows", "planes", "bitpacked")


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """One soa, dm or bp fused launch: `n_blocks` blocks of `threads`
    threads, each owning `rows` rows; output slabs of `slab` (`n_slabs` of
    them).  Spread blocks walk the trees `trees_per_chunk` at a time in
    `smem_bytes` of dynamic shared memory (the dm kernel adds
    SPREAD_WEIGHT_BYTES of static); row blocks (a thread a row) walk them
    all and hold the bins tile of `tile` (its global route past the opt-in
    limit)."""
    route: str
    rows: int
    threads: int
    trees_per_chunk: int
    slab: int
    n_slabs: int
    n_blocks: int
    smem_bytes: int
    tile: TilePlan | None = None


def fused_plan(n_rows: int, n_trees: int, depth: int, n_outputs: int,
               n_features: int, u8: bool, route: str | None = None,
               splits: str = "rows") -> FusedPlan:
    """The fused launch of soa (`splits` "rows"), depth_major ("planes":
    (D, T) split planes and level weights) or one bitpacked group
    ("bitpacked": (D, T) planes, no weights).  `route=None` picks spread
    up to SPREAD_MAX_ROWS rows (SPREAD_MAX_ROWS_DM for depth_major,
    SPREAD_MAX_ROWS_BP for bitpacked) where its smallest chunk fits shared
    memory beside the block's rows of bins, row otherwise; "spread" raises
    where it does not fit.  Spread: R = N // SM_COUNT rows a block (1 to
    SPREAD_MAX_BLOCK_ROWS), so the blocks reach min(N, SM_COUNT); trees a
    chunk up to SPREAD_PAIRS // R, in whole warps from 32 on, as many as
    fit (counted with each buffer's padding at its most).  At the
    1,024-row bucket (T = 1,000, depth 8, C = 7, 54 uint8 features): 7
    rows a block, 147 blocks of 512 threads, 128 trees a chunk; at 16
    rows one row a block and 1,000 trees a chunk; on every layout.  Row:
    `tile_shape(n_features, u8, planes=splits != "rows")`."""
    if route not in (None, "spread", "row"):
        raise ValueError(f"route is spread, row or None, not {route!r}")
    if splits not in SPLITS:
        raise ValueError(f"splits is one of {SPLITS}, not {splits!r}")
    spans = output_slabs(max(n_outputs, 1))
    slab = spans[0][1] - spans[0][0]
    bin_bytes = 1 if u8 else 4
    rows = min(SPREAD_MAX_BLOCK_ROWS, SPREAD_MAX_ACC * SPREAD_THREADS // slab,
               max(1, n_rows // SM_COUNT))
    n_trees, depth = max(n_trees, 1), max(depth, 0)
    limit = SPREAD_SMEM_LIMIT - (SPREAD_WEIGHT_BYTES if splits == "planes"
                                 else 0)

    fits = spread_smem_bytes(rows, 1, slab, depth, n_features,
                             bin_bytes) <= limit
    if route == "spread" and not fits:
        raise ValueError(
            f"{rows} rows of {n_features} bins and one tree's leaf values "
            f"pass {limit} bytes of shared memory: the spread route does "
            "not take this shape")
    max_rows = {"rows": SPREAD_MAX_ROWS, "planes": SPREAD_MAX_ROWS_DM,
                "bitpacked": SPREAD_MAX_ROWS_BP}[splits]
    if route == "spread" or (route is None and fits and n_rows <= max_rows):
        # spread_smem_bytes at its most: each buffer padded by 15 bytes,
        # each row of leaf values by 31 words
        fixed = (_align16(rows * n_features * bin_bytes)
                 + 2 * (rows * 31 * 4 + 15) + 30)
        per_tree = 8 * rows * slab + 4 * rows + 8 * depth
        chunk = max(1, min(n_trees, SPREAD_PAIRS // rows,
                           (limit - fixed) // per_tree))
        if 32 <= chunk < n_trees:
            chunk = chunk // 32 * 32
        return FusedPlan("spread", rows, SPREAD_THREADS, chunk, slab,
                         len(spans), -(-n_rows // rows),
                         spread_smem_bytes(rows, chunk, slab, depth,
                                           n_features, bin_bytes))
    tile = tile_shape(n_features, u8, planes=splits != "rows")
    return FusedPlan("row", tile.rows, tile.rows, n_trees, slab, len(spans),
                     -(-n_rows // tile.rows), tile.smem_bytes, tile)


# --------------------------------------------------------------------------
# csrc/leaf_index.cuh (leaf_index and leaf_index_dm)
# --------------------------------------------------------------------------
# A block of 8 warps owns `rows` rows, staged once as a transposed
# (F + 1, rows + 4) tile (a zero row last; the pitch an odd number of
# words), and walks the trees in rounds of 256, one a thread, staging each
# round's (D, 256) splits as 8-byte (feature offset, threshold) pairs.  A
# warp walks up to 32 rows (8 uint8 or 4 int32 words of 4 rows) of a
# 32-tree tile at a time.
INDEX_WARPS = 8
INDEX_ROUND_TREES = INDEX_WARPS * 32
INDEX_PAIR_BYTES = 8
INDEX_PITCH_PAD = 4
# Rows a block, largest first: the plan takes the first whose blocks fill
# the SMs (and that fits shared memory, or the global route).  64 is the
# bulk shape's best, 128 no better (scripts/leaf_index_probe.py); the
# kernel takes 8, 16 or a multiple of 32.
INDEX_ROWS = (64, 32, 16, 8)


@dataclasses.dataclass(frozen=True)
class IndexPlan:
    """The bins tile (staged, `tile.stride` is the pitch of a feature's
    column of `tile.rows` rows; on the global route, n_features, the
    bins' own row pitch), and a grid of (row blocks, tree groups), each
    group `rounds_per_group` rounds of INDEX_ROUND_TREES trees."""
    tile: TilePlan
    n_row_tiles: int
    n_tree_groups: int
    rounds_per_group: int

    @property
    def n_blocks(self) -> int:
        return self.n_row_tiles * self.n_tree_groups


def index_tile_bytes(rows: int, n_features: int, bin_bytes: int) -> int:
    """Shared bytes of a staged (F + 1, rows + 4) bins tile."""
    return (n_features + 1) * (rows + INDEX_PITCH_PAD) * bin_bytes


def index_plan(n_rows: int, n_trees: int, depth: int, n_features: int,
               bin_bytes: int) -> IndexPlan:
    """The launch of `leaf_index` / `leaf_index_dm`: the first of
    INDEX_ROWS whose row blocks, times the tree rounds, reach SM_COUNT
    blocks (else the fewest rows, which gives the most blocks there are),
    among those whose tile fits the opt-in limit beside the round's split
    pairs (else the global route, rows read where they lie); then the
    trees in as many groups as the row blocks need to reach SM_COUNT (one
    group when they already do).  At Covertype's width (54 uint8
    features, depth 8): 64 rows and one group at 139,440 rows; 16 rows and
    4 groups of one round at the 1,024-row bucket of 1,000 trees; 8 rows
    and one group for a depth group of a few trees at 1,024 rows, and 8
    rows and 4 groups at 16 rows."""
    pair_bytes = max(depth, 1) * INDEX_ROUND_TREES * INDEX_PAIR_BYTES
    rounds = max(1, -(-n_trees // INDEX_ROUND_TREES))
    fits = [r for r in INDEX_ROWS
            if pair_bytes + index_tile_bytes(r, n_features, bin_bytes)
            <= SMEM_OPTIN_LIMIT]
    route = "shared" if fits else "global"
    candidates = fits or list(INDEX_ROWS)
    rows = next((r for r in candidates
                 if -(-n_rows // r) * rounds >= SM_COUNT), candidates[-1])
    if fits:
        tile = TilePlan(rows, rows + INDEX_PITCH_PAD, route,
                        index_tile_bytes(rows, n_features, bin_bytes),
                        pair_bytes)
    else:
        tile = TilePlan(rows, n_features, route, 0, pair_bytes)
    row_tiles = max(1, -(-n_rows // rows))
    need = -(-SM_COUNT // row_tiles)
    per_group = 1 if need >= rounds else rounds // need
    return IndexPlan(tile, row_tiles, -(-rounds // per_group), per_group)


# --------------------------------------------------------------------------
# csrc/leaf_index_bp.cu
# --------------------------------------------------------------------------
# 32 rows a block (a lane each), staged once; 8 warps walk the trees in
# rounds of 256 (a 32-tree tile a warp), staging each round's (D, 256)
# planes as (feature, threshold) int32 pairs and writing each row's 256
# indexes as one contiguous kilobyte through 8 32 x 33-word transposes.
BP_ROWS = 32
BP_WARPS = 8
BP_TREE_TILE = 32
BP_ROUND_TREES = BP_WARPS * BP_TREE_TILE
BP_TRANSPOSE_BYTES = BP_WARPS * BP_ROWS * 33 * 4


@dataclasses.dataclass(frozen=True)
class BitpackedPlan:
    """The bins tile, and a grid of (row blocks, tree groups), each group
    `rounds_per_group` rounds of BP_ROUND_TREES trees."""
    tile: TilePlan
    n_row_tiles: int
    n_tree_groups: int
    rounds_per_group: int


def bp_plan(n_rows: int, n_trees: int, depth: int, n_features: int,
            bin_bytes: int) -> BitpackedPlan:
    """The bins tile of BP_ROWS rows (the global route when not even those
    fit the opt-in limit beside the transposes and split pairs); the trees
    in as many groups as the row blocks need to fill the SMs (one group
    when they already do).  At Covertype's width (54 uint8 features, depth
    8): 4,358 row blocks and one group at 139,440 rows, 32 row blocks and
    4 groups of one round at the 1,024-row bucket."""
    tile = _tile(n_features, bin_bytes, max_rows=BP_ROWS, granule=BP_ROWS,
                 static_bytes=BP_TRANSPOSE_BYTES
                 + max(depth, 1) * BP_ROUND_TREES * 8,
                 odd_stride=True, budgets=(SMEM_OPTIN_LIMIT,))
    row_tiles = max(1, -(-n_rows // BP_ROWS))
    rounds = max(1, -(-n_trees // BP_ROUND_TREES))
    groups = min(rounds, -(-SM_COUNT // row_tiles))
    per_group = -(-rounds // groups)
    return BitpackedPlan(tile, row_tiles, -(-rounds // per_group),
                         per_group)


# --------------------------------------------------------------------------
# The distance matrix (csrc/l2sq_matrix.cu) on sm_90
# --------------------------------------------------------------------------
# A block of MATRIX_THREADS (a producer warpgroup and two consumer
# warpgroups of 64 rows) owns a MATRIX_TILE_M x MATRIX_TILE_N output tile
# and walks K in stages of MATRIX_K_BLOCK fp32 (one 128-byte swizzle row),
# each stage the TF32 hi and lo parts of both operands' rows: 64 KB.  The
# split pass pads K with zeros to a multiple of MATRIX_K_BLOCK.
MATRIX_TILE_M = 128                # csrc/l2sq_matrix.cu kTileM
MATRIX_TILE_N = 128                # kTileN
MATRIX_K_BLOCK = 32                # kKBlock
MATRIX_THREADS = 384               # kThreads
MATRIX_STAGE_BYTES = 2 * (MATRIX_TILE_M + MATRIX_TILE_N) * MATRIX_K_BLOCK * 4
MATRIX_ALIGN = 1024                # slack to align the ring to the swizzle
MATRIX_BARRIER_BYTES = 16          # a full and an empty mbarrier a stage
GRID_X_LIMIT = 2 ** 31 - 1         # largest gridDim.x
TMA_COORD_LIMIT = 2 ** 31          # TMA coordinates are int32


@dataclasses.dataclass(frozen=True)
class MatrixPlan:
    """One distance-matrix launch: K padded to `k_pad`, a ring of
    `stages` stages in `smem_bytes` of dynamic shared memory, and one
    block for each of the m_tiles x n_tiles output tiles (M fastest)."""
    k_pad: int
    stages: int
    smem_bytes: int
    m_tiles: int
    n_tiles: int

    @property
    def grid(self) -> int:
        return self.m_tiles * self.n_tiles


def matrix_smem_bytes(stages: int) -> int:
    """Dynamic shared memory of a ring of `stages` stages."""
    return MATRIX_ALIGN + stages * (MATRIX_STAGE_BYTES + MATRIX_BARRIER_BYTES)


def matrix_max_stages() -> int:
    """The deepest ring the opt-in limit holds: 3 stages."""
    return (SMEM_OPTIN_LIMIT - SMEM_RESERVED_PER_BLOCK - MATRIX_ALIGN) \
        // (MATRIX_STAGE_BYTES + MATRIX_BARRIER_BYTES)


def matrix_plan(m: int, n: int, k: int) -> MatrixPlan:
    """The launch of `l2sq_matrix` for a (m, k) by (n, k) product, with
    the deepest ring that fits.  Raises where the grid or a TMA coordinate
    would overflow."""
    if max(m, n) >= TMA_COORD_LIMIT:
        raise ValueError(f"l2sq_matrix rows past int32: {m} x {n}")
    k_pad = max(MATRIX_K_BLOCK, -(-k // MATRIX_K_BLOCK) * MATRIX_K_BLOCK)
    m_tiles = -(-m // MATRIX_TILE_M)
    n_tiles = -(-n // MATRIX_TILE_N)
    if m_tiles * n_tiles > GRID_X_LIMIT:
        raise ValueError(f"l2sq_matrix grid too large: {m} x {n}")
    stages = matrix_max_stages()
    return MatrixPlan(k_pad, stages, matrix_smem_bytes(stages), m_tiles,
                      n_tiles)


# --------------------------------------------------------------------------
# One query against many reference rows (csrc/l2sq_rowwise.cu) on sm_90
# --------------------------------------------------------------------------
# A chunk is 128 columns: a float4 a lane.  A warp takes a row, holds J
# chunks of q and of its row in registers and issues all J row loads
# before its first multiply-add.  ptxas gives the instantiations 24-78
# registers and no spill, so ROWWISE_WAVE_WARPS warps (80 registers each)
# fit an SM.
ROWWISE_ROUTES = ("registers", "walk", "scalar")   # the launcher's route ids
ROWWISE_CHUNK = 128                # columns a chunk (32 lanes x 4)
ROWWISE_CHUNKS = (1, 2, 4, 8)      # J the kernel is instantiated for
ROWWISE_WARPS = (8, 4, 2, 1)       # warps a block, largest first
ROWWISE_WAVE_WARPS = 24            # warps an SM holds at 80 registers


@dataclasses.dataclass(frozen=True)
class RowwisePlan:
    """One `l2sq_rowwise` launch: the route, J chunks of 128 columns a
    warp holds at once (a pass over K on the walk route), warps a block (a
    row a warp), and blocks (one wave; the blocks stride over the rows
    when the rows need more)."""
    route: str
    chunks: int
    warps: int
    blocks: int

    @property
    def launch_args(self) -> tuple[int, int, int, int]:
        """The plan as the launcher takes it, after (n, k)."""
        return (ROWWISE_ROUTES.index(self.route), self.chunks, self.warps,
                self.blocks)


def rowwise_warps(n_warps: int) -> int:
    """Warps a block for `n_warps` warps of rows in one wave: the fewest
    warps the busiest SM holds, blocks dealt out evenly over SM_COUNT, the
    larger block on a tie.  Small blocks spread a ragged count evenly: at
    2,808 warps, 8 a block leaves some SMs 24 and others 16."""
    def busiest(w):
        return -(-(-(-n_warps // w)) // SM_COUNT) * w
    return min(ROWWISE_WARPS, key=lambda w: (busiest(w), -w))


def rowwise_plan(n: int, k: int, aligned: bool = True) -> RowwisePlan:
    """The launch of `l2sq_rowwise` for refs (n, k), a row a warp.

    Routes: `scalar` where float4 loads cannot go (K % 4 != 0, or q or
    the rows not 16-byte aligned: `aligned` False), masked scalar loads;
    else `registers` where K fits ROWWISE_CHUNKS[-1] chunks (q held in
    registers for every row, J the fewest chunks covering K, as a power of
    two), and past that `walk` (J = 8 chunks a pass, q's chunks taken
    again from L1).  Every route masks the rows past n and the columns
    past k, and sums each row in one order.

    Where the n warps fit one wave of SM_COUNT x ROWWISE_WAVE_WARPS, a
    block a few of them (`rowwise_warps`); else one wave of 8-warp blocks
    strides over the rows.  At the kNN shape (2,808 x 512): registers,
    J = 4, 2 warps a block, 1,404 blocks."""
    if not aligned or k % 4:
        route, chunks = "scalar", 1
    else:
        need = max(1, -(-k // ROWWISE_CHUNK))
        if need <= ROWWISE_CHUNKS[-1]:
            route = "registers"
            chunks = next(j for j in ROWWISE_CHUNKS if j >= need)
        else:
            route, chunks = "walk", ROWWISE_CHUNKS[-1]
    wave = SM_COUNT * ROWWISE_WAVE_WARPS
    if n <= wave:
        warps = rowwise_warps(max(1, n))
        blocks = -(-max(1, n) // warps)
    else:
        warps = ROWWISE_WARPS[0]
        blocks = wave // warps
    return RowwisePlan(route, chunks, warps, blocks)
