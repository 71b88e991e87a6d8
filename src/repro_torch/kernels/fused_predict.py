"""Fused binarize -> leaf index -> leaf gather on Hopper.

The kernel is `csrc/fused_predict.cu`; it replaces the TPU kernel
`src/repro/kernels/fused_predict.py:fused_predict`.  Its plain version is
`ref.fused_predict`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.leaf_gather import MAX_OUTPUTS
from repro_torch.kernels.leaf_index import MAX_DEPTH, TILE_BYTES

# One thread per row: 128 rows (4 warps) a block.  At Covertype's width
# the uint8 bins tile is 7.5 KB, so 16 blocks (the SM's 2,048 threads)
# fit one SM's shared memory, and N = 139,440 rows make 1,090 blocks,
# about 8 for each of the 132 SMs.  Wide rows take fewer, in whole warps.
ROWS_PER_BLOCK = 128
WARP = 32


def tile_shape(n_features: int, u8: bool) -> tuple[int, int]:
    """(rows a block, row stride in bins) of the shared bins tile.

    The stride is an odd number of 4-byte words, so the 32 rows a warp
    reads at one feature sit in 32 distinct shared-memory banks."""
    bin_bytes = 1 if u8 else 4
    words = (n_features * bin_bytes + 3) // 4 | 1
    stride = words * 4 // bin_bytes
    fit = TILE_BYTES // (stride * bin_bytes)
    rows = min(ROWS_PER_BLOCK, fit // WARP * WARP)
    if rows < WARP:
        raise ValueError(f"fused_predict: {n_features} features leave no "
                         f"room for {WARP} rows of bins in {TILE_BYTES} "
                         "bytes of shared memory")
    return rows, stride


def fused_predict(x: torch.Tensor, borders: torch.Tensor,
                  split_features: torch.Tensor, split_bins: torch.Tensor,
                  leaf_values: torch.Tensor) -> torch.Tensor:
    """Fused GBDT predict -> (N, C) float32 raw tree sums.

    The bins of a row block stay on chip, as uint8 when B <= 255 and as
    int32 otherwise.  A tensor on the CPU goes through the plain
    version; a CUDA tensor launches the kernel (and adds one to
    `fused_predict.launches`)."""
    if x.ndim != 2 or borders.ndim != 2 or x.shape[1] != borders.shape[1] \
            or split_features.ndim != 2 \
            or split_features.shape != split_bins.shape \
            or leaf_values.ndim != 3 \
            or leaf_values.shape[0] != split_features.shape[0]:
        raise ValueError(
            f"fused_predict takes x (N, F), borders (B, F), splits (T, D) "
            f"and leaf values (T, L, C), got {tuple(x.shape)}, "
            f"{tuple(borders.shape)}, {tuple(split_features.shape)}, "
            f"{tuple(split_bins.shape)} and {tuple(leaf_values.shape)}")
    if x.device.type == "cpu":
        return ref.fused_predict(x, borders, split_features, split_bins,
                                 leaf_values)
    _build.check_cuda_tensors("fused_predict", x=(x, torch.float32),
                              borders=(borders, torch.float32),
                              split_features=(split_features, torch.int32),
                              split_bins=(split_bins, torch.int32),
                              leaf_values=(leaf_values, torch.float32))
    n, f = x.shape
    n_borders = borders.shape[0]
    t, d = split_features.shape
    c = leaf_values.shape[2]
    if d > MAX_DEPTH or leaf_values.shape[1] != 1 << d:
        raise ValueError(f"fused_predict takes depth <= {MAX_DEPTH} with "
                         f"2^depth leaves, got depth {d} and "
                         f"{leaf_values.shape[1]} leaves")
    if c > MAX_OUTPUTS:
        raise ValueError(f"fused_predict takes <= {MAX_OUTPUTS} outputs, "
                         f"got {c}")
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n and c:
        u8 = n_borders <= ref.MAX_U8_BORDERS
        rows, stride = tile_shape(f, u8)
        _build.launch("repro_fused_predict", x.device, x, borders,
                      split_features, split_bins, leaf_values, out, n, f,
                      n_borders, t, d, c, int(u8), stride, rows)
        fused_predict.launches += 1
    return out


fused_predict.launches = 0
