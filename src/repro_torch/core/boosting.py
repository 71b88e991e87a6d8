"""Histogram-based gradient boosting of oblivious decision trees.

The port's counterpart of `src/repro/core/boosting.py`.  Each boosting
iteration fits one oblivious tree:

  level d in 0..depth-1:
    hist[f, leaf, bin] <- segment-sum of (g, h) over (current leaf, bin)
    gain[f, b] = sum_leaf  G_l^2/(H_l+l2)  for left/right partitions
    the SAME (f*, b*) split is applied to every leaf  (oblivious)
    leaf |= [bins[:, f*] >= b*] << d

  leaf values: w_l = -lr * G_l / (H_l + l2)    (Newton step)

Two trainers share this math, as in the JAX package:

  * `fit` is a front end over `repro_torch.training.gbdt.GBDTTrainer`:
    the float matrix is binarized once into a uint8 `QuantizedPool`
    (int32 bins past 255 borders) and boosting runs the registered
    `histogram` op over it, on the card unless the caller asks for the
    CPU.
  * `fit_scan` is the seed float trainer, the JAX package's differential
    oracle: it binarizes its own matrix and sums histograms in f32 by
    segment, a loop over trees.  JAX computes it outside any Pallas
    kernel, so it is plain torch here.

Both draw from JAX's threefry stream (`core.prng`) as JAX does: the
carried key splits into (key, sub, sub2) every tree; `rsm < 1` keeps the
first max(1, int(F * rsm)) features of `permutation(sub, F)` for the
tree's splits, and ordered boosting (CatBoost's prefix Newton estimates
along `permutation(sub2, N)`, which removes prediction shift) updates
each sample's raw prediction from the samples before it in its leaf.
The stored leaf values use all samples either way.

Every float sum here runs in an order fixed by the shapes, so the card
gives the same bits on every run: the split search's scans and sums
and ordered boosting's prefix sums add in the order of the JAX
package's compiled trainer (`core.split_sums`, so that exact gain ties
resolve as they do there), and `_segment_sum` sorts rows stably by
segment and sums each segment in row order (`torch.segment_reduce`),
where `index_add_` would add with float atomics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core import prng, quantize, split_sums
from repro_torch.core.predictor import resolve_device
from repro_torch.core.split_sums import NEG_INF
from repro_torch.core.trees import ObliviousEnsemble


@dataclasses.dataclass(frozen=True)
class BoostingParams:
    n_trees: int = 100
    depth: int = 6
    learning_rate: float = 0.1
    l2_reg: float = 3.0
    max_bins: int = 64
    rsm: float = 1.0              # feature subsample per tree
    ordered: bool = False         # CatBoost-style ordered boosting
    seed: int = 0


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sums of (N, K) `x` down its rows, in the order
    of `jnp.cumsum` on XLA's CPU backend (`split_sums.blocked_cumsum`).
    It is built from whole-tensor adds, so the card sums in the same
    fixed order; torch's own scan of a 1-d tensor goes through a
    decoupled look-back there, whose float sums depend on timing."""
    return split_sums.blocked_cumsum(x, dim=0)


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 n_segments: int) -> torch.Tensor:
    """(n_segments, K) f32 sums of the rows of (M, K) `values` by segment
    id: the rows sorted stably by segment, each segment summed in row
    order."""
    order = torch.sort(segments, stable=True).indices
    lengths = torch.bincount(segments, minlength=n_segments)
    return torch.segment_reduce(values[order], "sum", lengths=lengths,
                                axis=0)


def _ordered_update(leaf, g, h, key, lr, l2):
    """Per-sample raw updates from PREFIX statistics along the random
    permutation of `key`, grouped by leaf, on the device of `leaf`.

    The integer parts are exact: `pos` is the inverse permutation (the
    rank of sample i), and the leaf-grouped rank order is the argsort of
    leaf * N + pos, whose keys are unique (JAX's lexsort((pos, leaf))).
    The float part is the JAX package's f32 formula: the exclusive prefix
    over all rows in that order, minus its value at the row's segment
    start."""
    n, c = g.shape
    dev = leaf.device
    perm = prng.permutation(key, n, dev)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(n, device=dev)
    order = torch.argsort(leaf.long() * n + pos)
    gh = torch.cat([g, h], dim=1)[order]
    leaf_s = leaf[order]
    excl = _prefix_sum(gh) - gh
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = leaf_s[1:] != leaf_s[:-1]
    idx = torch.arange(n, device=dev)
    last_start = torch.cummax(torch.where(start, idx, -1), dim=0).values
    prefix = excl - excl[last_start]           # within-leaf exclusive prefix
    w_sorted = -lr * prefix[:, :c] / (prefix[:, c:] + l2)
    out = torch.zeros_like(g)
    out[order] = w_sorted
    return out


def _stack(rows: list, empty_shape: tuple, dtype, device) -> torch.Tensor:
    return (torch.stack(rows) if rows
            else torch.zeros(empty_shape, dtype=dtype, device=device))


def _build_tree(bins, g, h, n_borders, key, *, depth: int, max_bins: int,
                l2: float, rsm: float):
    """Fit one oblivious tree on (N, F) bins: the JAX package's
    `_build_tree`, with every level's histogram over all 2^depth leaves.
    Returns (sf (D,), sb (D,), sum_g, sum_h per leaf, leaf (N,))."""
    n, n_feat = bins.shape
    c = g.shape[1]
    b, n_leaves = max_bins, 1 << depth     # bin ids in [0, max_bins - 1]
    dev = bins.device
    feat_ok = torch.ones(n_feat, dtype=torch.bool, device=dev)
    if rsm < 1.0:
        keep = max(1, int(n_feat * rsm))
        feat_ok = torch.zeros_like(feat_ok)
        feat_ok[prng.permutation(key, n_feat, dev)[:keep]] = True
    b_iota = torch.arange(b, device=dev)
    # valid split borders: 1 <= b <= n_borders[f]
    valid = (b_iota[None, :] >= 1) & (b_iota[None, :] <= n_borders[:, None]) \
        & feat_ok[:, None]                                      # (F, B)
    gh = torch.cat([g, h], dim=1)
    gh_rows = gh.repeat(n_feat, 1)                  # one copy a feature
    bins_t = bins.t().long()
    feat_base = torch.arange(n_feat, device=dev)[:, None] * (n_leaves * b)
    leaf = torch.zeros(n, dtype=torch.long, device=dev)
    sf, sb = [], []
    for d in range(depth):
        seg = feat_base + leaf[None, :] * b + bins_t           # (F, N)
        hist = _segment_sum(gh_rows, seg.reshape(-1),
                            n_feat * n_leaves * b).view(n_feat, n_leaves,
                                                        b, 2 * c)
        gain, nonempty = split_sums.level_gains(hist, l2)         # (F, B)
        gain = torch.where(valid & nonempty, gain, NEG_INF)
        flat = torch.argmax(gain.reshape(-1))
        f_star = torch.div(flat, b, rounding_mode="floor")
        b_star = flat % b
        column = bins_t.index_select(0, f_star.view(1))[0]
        leaf = leaf | ((column >= b_star).long() << d)
        sf.append(f_star)
        sb.append(b_star)
    s = _segment_sum(gh, leaf, n_leaves)                        # (L, 2C)
    return (_stack(sf, (0,), torch.long, dev),
            _stack(sb, (0,), torch.long, dev), s[:, :c], s[:, c:], leaf)


def _fit_scan(bins, y, raw0, n_borders, key, *, loss, depth, max_bins,
              n_trees, lr, l2, rsm, ordered=False):
    """The JAX package's `_fit_scan`, a loop over trees.  Returns (raw,
    split features (T, D), split bins (T, D), leaf values (T, L, C), the
    loss after each tree (T,))."""
    raw = raw0
    sfs, sbs, ws, vals = [], [], [], []
    for _ in range(n_trees):
        key, sub, sub2 = prng.split(key, 3)
        g, h = loss.grad_hess(raw, y)
        sf, sb, sum_g, sum_h, leaf = _build_tree(
            bins, g, h, n_borders, sub, depth=depth, max_bins=max_bins,
            l2=l2, rsm=rsm)
        w = -lr * sum_g / (sum_h + l2)                          # (L, C)
        if ordered:
            raw = raw + _ordered_update(leaf, g, h, sub2, lr, l2)
        else:
            raw = raw + w[leaf]
        sfs.append(sf)
        sbs.append(sb)
        ws.append(w)
        vals.append(loss.value(raw, y))
    dev, c = raw0.device, raw0.shape[1]
    return (raw, _stack(sfs, (0, depth), torch.long, dev),
            _stack(sbs, (0, depth), torch.long, dev),
            _stack(ws, (0, 1 << depth, c), torch.float32, dev),
            _stack(vals, (0,), torch.float32, dev))


def fit(x: np.ndarray, y: np.ndarray, *, loss: losses_lib.Loss,
        params: BoostingParams,
        borders: Optional[torch.Tensor] = None,
        n_borders: Optional[torch.Tensor] = None,
        device: torch.device | str = "cuda", backend: str = "auto"):
    """Train a GBDT on raw float features -> (ensemble, history).

    Quantizes once on `device` into a uint8 pool (or int32 bins when the
    borders exceed the uint8 bin space) and boosts on that, with the JAX
    package's math and history."""
    # lazy import: training.gbdt imports this module for the shared math
    from repro_torch.training import gbdt as gbdt_lib

    x = np.asarray(x, np.float32)
    if borders is None:
        borders, n_borders = quantize.compute_borders(x, params.max_bins)
    trainer = gbdt_lib.GBDTTrainer(loss, params, device=device,
                                   backend=backend)
    dev_borders = torch.as_tensor(borders).to(trainer.device)
    xd = torch.as_tensor(x, device=trainer.device)
    if int(borders.shape[0]) <= quantize.MAX_BINS - 1:
        pool = quantize.quantize_pool(xd, dev_borders, backend=backend)
        return trainer.fit_pool(pool, y, borders=borders,
                                n_borders=n_borders)
    bins = quantize.binarize_matrix(xd, dev_borders, backend=backend)
    return trainer.fit_bins(bins, y, borders=borders, n_borders=n_borders)


def fit_scan(x: np.ndarray, y: np.ndarray, *, loss: losses_lib.Loss,
             params: BoostingParams,
             borders: Optional[torch.Tensor] = None,
             n_borders: Optional[torch.Tensor] = None,
             device: torch.device | str = "cuda", backend: str = "auto"):
    """The seed float trainer on `device` -> (ensemble, history).

    Binarizes its own float matrix (one `binarize` dispatch) and sums the
    histograms in f32 by segment: the JAX package's benchmark baseline and
    differential oracle for the quantized-first trainer."""
    x = np.asarray(x, np.float32)
    dev = resolve_device(device)
    if borders is None:
        borders, n_borders = quantize.compute_borders(x, params.max_bins)
    borders = torch.as_tensor(borders, dtype=torch.float32).cpu()
    if n_borders is None:
        n_borders = torch.isfinite(borders).sum(0)
    n_borders = torch.as_tensor(n_borders).to(torch.int32).cpu()
    bins = quantize.binarize_matrix(torch.as_tensor(x, device=dev),
                                    borders.to(dev), backend=backend)
    yt = losses_lib.as_labels(y, dev)
    raw0 = loss.init_raw(yt)
    raw, sfs, sbs, ws, vals = _fit_scan(
        bins, yt, raw0, n_borders.to(dev), prng.initial_key(params.seed),
        loss=loss, depth=params.depth, max_bins=params.max_bins,
        n_trees=params.n_trees, lr=params.learning_rate, l2=params.l2_reg,
        rsm=params.rsm, ordered=params.ordered)
    ensemble = ObliviousEnsemble(
        split_features=sfs.cpu(), split_bins=sbs.cpu(),
        leaf_values=ws.cpu(), borders=borders, n_borders=n_borders,
        base_score=raw0[0].cpu())
    history = {"train_loss": vals.cpu().numpy().astype(np.float32),
               "final_metric": float(loss.metric(raw, yt))}
    return ensemble, history
