"""Plain PyTorch versions of the port's kernels.

Each CUDA kernel in `csrc/` computes the function of the same name here.
The CPU path and the tests run these; `chip_smoke.py` holds every kernel
against them on the card.  They mirror `src/repro/kernels/ref.py`.

Conventions (CatBoost's oblivious-tree model):
  x              (N, F)  float32   raw feature matrix
  borders        (B, F)  float32   per-feature bin borders, padded with +inf
  bins           (N, F)  int32 | uint8  #borders strictly below x
  split_features (T, D)  int32     feature id used at depth d of tree t
  split_bins     (T, D)  int32     border id; go right iff bins[f] >= split_bin
  leaf_values    (T, 2^D, C) float32
  leaf index     idx[n, t] = sum_d 2^d * [bins[n, sf[t, d]] >= sb[t, d]]
"""
from __future__ import annotations

import torch

# Largest border count whose bin ids fit one byte (CatBoost's 255-border
# cap: ids span [0, B]).
MAX_U8_BORDERS = 255


def binarize(x: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """bins[n, f] = #{b : x[n, f] > borders[b, f]} -> (N, F) int32.

    Strict `>`: NaN compares false and lands in bin 0; +inf padding
    borders are never crossed."""
    return (x[:, None, :] > borders[None, :, :]).sum(dim=1,
                                                     dtype=torch.int32)


def binarize_u8(x: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """`binarize` as the one-byte quantized-pool stream (B <= 255).

    The same compare-sum as `binarize`, so NaN needs no mask (a
    `searchsorted` form would sort NaN past +inf and has to mask it)."""
    if borders.shape[0] > MAX_U8_BORDERS:
        raise ValueError(f"uint8 bins need <= {MAX_U8_BORDERS} borders, got "
                         f"{borders.shape[0]}")
    return binarize(x, borders).to(torch.uint8)


def leaf_index(bins: torch.Tensor, split_features: torch.Tensor,
               split_bins: torch.Tensor) -> torch.Tensor:
    """idx[n, t] = sum_d 2^d * [bins[n, sf[t, d]] >= sb[t, d]] -> (N, T)
    int32.  `bins` may be int32 or uint8.

    The compare runs in int32, so the 2^30 PAD_SPLIT_BIN of padded trees
    and truncated levels never goes right."""
    n = bins.shape[0]
    t, d = split_features.shape
    idx = torch.zeros((n, t), dtype=torch.int32, device=bins.device)
    for level in range(d):
        gathered = torch.index_select(bins, 1,
                                      split_features[:, level].long())
        go_right = gathered.to(torch.int32) >= split_bins[:, level]
        idx |= go_right.to(torch.int32) << level
    return idx


def leaf_gather(idx: torch.Tensor, leaf_values: torch.Tensor) -> torch.Tensor:
    """pred[n, c] = sum_t leaf_values[t, idx[n, t], c] -> (N, C) float32."""
    t, n_leaves, c = leaf_values.shape
    flat = leaf_values.reshape(t * n_leaves, c)
    offsets = torch.arange(t, device=idx.device) * n_leaves
    return flat[idx.long() + offsets].sum(dim=1)


def fused_predict(x: torch.Tensor, borders: torch.Tensor,
                  split_features: torch.Tensor, split_bins: torch.Tensor,
                  leaf_values: torch.Tensor) -> torch.Tensor:
    """binarize -> leaf_index -> leaf_gather as one function -> (N, C)."""
    bins = binarize(x, borders)
    return leaf_gather(leaf_index(bins, split_features, split_bins),
                       leaf_values)
