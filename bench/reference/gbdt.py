"""Oblivious-tree ensembles in plain PyTorch: applying one, and the pieces
of growing one.

The model is CatBoost's, in structure-of-arrays form:

  split_features (T, D)  feature tested at depth d of tree t
  split_bins     (T, D)  a row goes right at depth d iff its bin of that
                         feature is >= split_bins[t, d]
  leaf_values    (T, 2^D, C)
  borders        (B, F)  sorted borders of each feature
  base_score     (C,)

A value's bin is the number of borders it lies strictly above, so NaN
lands in bin 0.  A row's leaf in tree t is sum_d 2^d [bin >= split_bin].
Raw scores are the sum of the row's leaves over the trees plus the base
score; probabilities are the softmax of the raw scores, or, with one
output, the two columns (1 - sigmoid, sigmoid).

Every function runs on the device of its inputs, in blocks of rows and
trees, so that the whole ensemble at its published size fits beside
nothing else.  `dtype` is float64 for the reference and something lower
for a control.
"""
from __future__ import annotations

import torch


def binarize(x: torch.Tensor, borders: torch.Tensor, *,
             row_block: int = 8192) -> torch.Tensor:
    """(N, F) values, (B, F) borders -> (N, F) int64 bins: how many
    borders each value lies strictly above (NaN: none)."""
    out = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    for r0 in range(0, x.shape[0], row_block):
        blk = x[r0:r0 + row_block]
        out[r0:r0 + row_block] = (blk[:, None, :] > borders[None]).sum(1)
    return out


def leaf_index(bins: torch.Tensor, split_features: torch.Tensor,
               split_bins: torch.Tensor) -> torch.Tensor:
    """(N, F) bins, (T, D) splits -> (N, T) int64 leaf of each row in each
    tree."""
    sf = split_features.long()
    sb = split_bins.long()
    idx = torch.zeros((bins.shape[0], sf.shape[0]), dtype=torch.int64,
                      device=bins.device)
    for d in range(sf.shape[1]):
        idx |= (bins[:, sf[:, d]] >= sb[None, :, d]).long() << d
    return idx


def raw_scores(bins: torch.Tensor, split_features: torch.Tensor,
               split_bins: torch.Tensor, leaf_values: torch.Tensor,
               base_score: torch.Tensor, *, dtype=torch.float64,
               leaf_dtype=None, row_block: int = 8192, tree_block: int = 512
               ) -> torch.Tensor:
    """(N, C) raw scores in `dtype`: the trees' leaves summed in tree order,
    then the base score.  In float64 a block of trees is summed at once (the
    order changes nothing at that precision); in any lower precision every
    tree is one add of the running sum, as a float32 program adds them.
    With `leaf_dtype` the leaf values are rounded to it first (a leaf table
    kept in a lower precision than its sums)."""
    n_trees, _, n_out = leaf_values.shape
    lv = leaf_values if leaf_dtype is None else leaf_values.to(leaf_dtype)
    lv = lv.to(dtype)
    base = base_score.to(dtype)
    out = torch.empty((bins.shape[0], n_out), dtype=dtype,
                      device=bins.device)
    for r0 in range(0, bins.shape[0], row_block):
        b = bins[r0:r0 + row_block]
        acc = torch.zeros((b.shape[0], n_out), dtype=dtype, device=b.device)
        for t0 in range(0, n_trees, tree_block):
            t1 = min(t0 + tree_block, n_trees)
            idx = leaf_index(b, split_features[t0:t1], split_bins[t0:t1])
            trees = torch.arange(t0, t1, device=b.device)[None, :]
            vals = lv[trees, idx]                        # (rows, trees, C)
            if dtype == torch.float64:
                acc += vals.sum(1)
            else:
                for j in range(t1 - t0):
                    acc = acc + vals[:, j]
        out[r0:r0 + row_block] = acc + base
    return out


def proba(raw: torch.Tensor) -> torch.Tensor:
    """Raw scores -> probabilities: softmax over C > 1 outputs, (1 - p, p)
    with p = sigmoid for one."""
    if raw.shape[1] == 1:
        p = torch.sigmoid(raw[:, 0])
        return torch.stack([1.0 - p, p], dim=1)
    return torch.softmax(raw, dim=-1)


# ---------------------------------------------------------------------------
# Growing a tree (MultiClass, Newton leaves, oblivious splits)
# ---------------------------------------------------------------------------
def grad_hess_multiclass(raw: torch.Tensor, y: torch.Tensor
                         ) -> torch.Tensor:
    """(N, C) raw, (N,) class ids -> (N, 2C): the softmax cross-entropy's
    gradients p - onehot, then its diagonal hessians p (1 - p) (floored
    at 1e-12, so that a sure class keeps a positive mass)."""
    p = torch.softmax(raw, dim=-1)
    onehot = torch.nn.functional.one_hot(y.long(), raw.shape[1]).to(p.dtype)
    h = torch.clamp(p * (1 - p), min=1e-12)
    return torch.cat([p - onehot, h], dim=1)


def level_histogram(bins: torch.Tensor, leaf: torch.Tensor,
                    gh: torch.Tensor, *, n_leaves: int, n_bins: int,
                    feature_block: int = 8) -> torch.Tensor:
    """(N, F) bins, (N,) leaf ids, (N, S) stats -> (F, n_leaves, n_bins, S)
    sums of each stat over the rows of each (feature, leaf, bin) cell, in
    the stats' dtype."""
    n, n_feat = bins.shape
    s = gh.shape[1]
    out = torch.zeros((n_feat * n_leaves * n_bins, s), dtype=gh.dtype,
                      device=gh.device)
    leaf = leaf.long()
    for f0 in range(0, n_feat, feature_block):
        f1 = min(f0 + feature_block, n_feat)
        feats = torch.arange(f0, f1, device=bins.device)[None, :]
        cell = (feats * n_leaves + leaf[:, None]) * n_bins + bins[:, f0:f1]
        src = gh[:, None, :].expand(n, f1 - f0, s).reshape(-1, s)
        out.index_add_(0, cell.reshape(-1), src)
    return out.view(n_feat, n_leaves, n_bins, s)


def split_gains(hist: torch.Tensor, n_borders: torch.Tensor,
                l2: float) -> torch.Tensor:
    """(F, L, B, 2C) histogram -> (F, B) gain of the split `bin >= b` in
    every leaf at once: sum over leaves and outputs of G^2 / (H + l2) on
    each side.  A split counts where 1 <= b <= n_borders[f] and hessian
    mass lies on both sides; every other entry is -inf."""
    c = hist.shape[-1] // 2
    incl = torch.cumsum(hist, dim=2)
    total = incl[:, :, -1:, :]
    left = torch.nn.functional.pad(incl[:, :, :-1, :], (0, 0, 1, 0))
    right = total - left

    def term(side):
        return side[..., :c] ** 2 / (side[..., c:] + l2)

    gain = (term(left) + term(right)).sum(dim=(1, 3))
    b = torch.arange(hist.shape[2], device=hist.device)[None, :]
    valid = (b >= 1) & (b <= n_borders.to(hist.device)[:, None]) \
        & (left[..., c:].sum(dim=(1, 3)) > 0) \
        & (right[..., c:].sum(dim=(1, 3)) > 0)
    return torch.where(valid, gain, torch.full_like(gain, -torch.inf))


def leaf_values(gh: torch.Tensor, leaf: torch.Tensor, *, n_leaves: int,
                learning_rate: float, l2: float) -> torch.Tensor:
    """(L, C) Newton leaf values -lr * G / (H + l2) of each leaf's rows."""
    c = gh.shape[1] // 2
    sums = torch.zeros((n_leaves, gh.shape[1]), dtype=gh.dtype,
                       device=gh.device).index_add_(0, leaf.long(), gh)
    return -learning_rate * sums[:, :c] / (sums[:, c:] + l2)
