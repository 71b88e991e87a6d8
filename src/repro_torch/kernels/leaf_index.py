"""Oblivious-tree leaf indexes (paper: CalcIndexesBasic) on Hopper.

The kernel is `csrc/leaf_index.cu`, one template for int32 and uint8
bins; it replaces the TPU kernels `src/repro/kernels/leaf_index.py:
leaf_index` and `leaf_index_u8`.  Its plain version is `ref.leaf_index`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Deepest tree the kernels take (csrc/common.cuh kMaxDepth).
MAX_DEPTH = 16
# A block stages up to 128 rows of bins in shared memory, fewer when a
# row is wide, so the tile stays within the 48 KB a block gets without
# opting in to more.  Rows come in multiples of the block's 8 warps.
MAX_TILE_ROWS = 128
TILE_BYTES = 48 * 1024
ROW_GROUPS = 8


def tile_rows(n_features: int, bin_bytes: int) -> int:
    """Rows of bins one block stages: as many as fit `TILE_BYTES`, at
    most `MAX_TILE_ROWS`, in multiples of `ROW_GROUPS`."""
    fit = TILE_BYTES // max(n_features * bin_bytes, 1)
    rows = min(MAX_TILE_ROWS, fit // ROW_GROUPS * ROW_GROUPS)
    if rows < ROW_GROUPS:
        raise ValueError(f"{n_features} features of {bin_bytes}-byte bins "
                         f"leave no room for {ROW_GROUPS} rows in "
                         f"{TILE_BYTES} bytes of shared memory")
    return rows


def leaf_index(bins: torch.Tensor, split_features: torch.Tensor,
               split_bins: torch.Tensor) -> torch.Tensor:
    """idx[n, t] = sum_d 2^d [bins[n, sf[t, d]] >= sb[t, d]] -> (N, T)
    int32, from int32 or uint8 bins.  Every split feature must lie in
    [0, F) (`core.layout.lower` checks this once per model).

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the kernel (and adds one to `leaf_index.launches`)."""
    if bins.ndim != 2 or split_features.ndim != 2 \
            or split_features.shape != split_bins.shape:
        raise ValueError(f"leaf_index takes bins (N, F) and splits (T, D), "
                         f"got {tuple(bins.shape)}, "
                         f"{tuple(split_features.shape)} and "
                         f"{tuple(split_bins.shape)}")
    if bins.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"bins are int32 or uint8, not {bins.dtype}")
    if bins.device.type == "cpu":
        return ref.leaf_index(bins, split_features, split_bins)
    _build.check_cuda_tensors("leaf_index", bins=(bins, bins.dtype),
                              split_features=(split_features, torch.int32),
                              split_bins=(split_bins, torch.int32))
    n, f = bins.shape
    t, d = split_features.shape
    if d > MAX_DEPTH:
        raise ValueError(f"leaf_index takes depth <= {MAX_DEPTH}, got {d}")
    out = torch.empty((n, t), dtype=torch.int32, device=bins.device)
    if n and t:
        u8 = bins.dtype == torch.uint8
        _build.launch("repro_leaf_index", bins.device, bins, split_features,
                      split_bins, out, n, f, t, d, int(u8),
                      tile_rows(f, 1 if u8 else 4))
        leaf_index.launches += 1
    return out


leaf_index.launches = 0
