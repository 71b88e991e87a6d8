"""Oblivious-tree leaf indexes (paper: CalcIndexesBasic) on Hopper.

Three kernels, one for each way a layout holds its splits:

  leaf_index     `csrc/leaf_index.cu`: (T, D) splits (soa, depth_grouped);
                 replaces `src/repro/kernels/leaf_index.py:leaf_index` and
                 `leaf_index_u8`.  Plain version `ref.leaf_index`.
  leaf_index_dm  `csrc/leaf_index_dm.cu`: (D, T) planes and the per-level
                 weights (depth_major); replaces `leaf_index_dm`.  Plain
                 version `ref.leaf_index_depth_major`.
  leaf_index_bp  `csrc/leaf_index_bp.cu`: (D, T) planes, uint8 or int32
                 thresholds, 32-row compare words (bitpacked); replaces
                 `leaf_index_bp`.  Plain version `ref.leaf_index_bitpacked`.

Each takes int32 or uint8 bins, and any number of features: the rows of
a block are staged in shared memory while they fit the opt-in limit and
read from global memory past it.  `leaf_index` and `leaf_index_dm` are one
kernel body (`csrc/leaf_index.cuh`): a block stages its rows once as a
transposed tile, walks the trees in rounds of 256 (one a lane), reads 4
rows' bins of a feature in one shared word and compares uint8 bins 4 at
a time inside it; `tuning.index_plan` picks its rows a block and splits
the trees into groups where the row blocks alone would not fill the card.
`leaf_index_bp` has its own (`tuning.bp_plan`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.tuning import bp_plan, index_plan
from repro_torch.obs.trace import get_tracer, plan_attrs

# Deepest tree the kernels take (csrc/common.cuh kMaxDepth).
MAX_DEPTH = 16
_TRACER = get_tracer()


def _check_index_args(name: str, bins: torch.Tensor, planes) -> None:
    if bins.ndim != 2 or any(p.ndim != 2 for p in planes) \
            or any(p.shape != planes[0].shape for p in planes):
        raise ValueError(f"{name} takes bins (N, F) and split arrays of one "
                         f"2-d shape, got {tuple(bins.shape)} and "
                         f"{[tuple(p.shape) for p in planes]}")
    if bins.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"bins are int32 or uint8, not {bins.dtype}")


def leaf_index(bins: torch.Tensor, split_features: torch.Tensor,
               split_bins: torch.Tensor) -> torch.Tensor:
    """idx[n, t] = sum_d 2^d [bins[n, sf[t, d]] >= sb[t, d]] -> (N, T)
    int32, from int32 or uint8 bins.  Every split feature must lie in
    [0, F) (`core.layout.lower` checks this once per model).

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the kernel (and adds one to `leaf_index.launches`)."""
    _check_index_args("leaf_index", bins, (split_features, split_bins))
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
        plan = index_plan(n, t, d, f, 1 if u8 else 4)
        if _TRACER.enabled:
            _TRACER.annotate(**plan_attrs(plan))
        _build.launch("repro_leaf_index", bins.device, bins, split_features,
                      split_bins, out, n, f, t, d, int(u8), plan.tile.rows,
                      int(plan.tile.route == "global"), plan.n_tree_groups,
                      plan.rounds_per_group)
        leaf_index.launches += 1
    return out


leaf_index.launches = 0


def leaf_index_dm(bins: torch.Tensor, split_features_dm: torch.Tensor,
                  split_bins_dm: torch.Tensor,
                  pow2: torch.Tensor) -> torch.Tensor:
    """idx[n, t] = sum_d pow2[d] [bins[n, sf_dm[d, t]] >= sb_dm[d, t]] ->
    (N, T) int32, from the depth-major (D, T) int32 planes and the (D, 1)
    f32 level weights 2^d.  Every split feature must lie in [0, F).

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the kernel (and adds one to `leaf_index_dm.launches`)."""
    _check_index_args("leaf_index_dm", bins,
                      (split_features_dm, split_bins_dm))
    if pow2.shape != (split_features_dm.shape[0], 1):
        raise ValueError(f"pow2 must be (D, 1) = "
                         f"({split_features_dm.shape[0]}, 1), got "
                         f"{tuple(pow2.shape)}")
    if bins.device.type == "cpu":
        return ref.leaf_index_depth_major(bins, split_features_dm,
                                          split_bins_dm, pow2)
    _build.check_cuda_tensors(
        "leaf_index_dm", bins=(bins, bins.dtype),
        split_features_dm=(split_features_dm, torch.int32),
        split_bins_dm=(split_bins_dm, torch.int32),
        pow2=(pow2, torch.float32))
    n, f = bins.shape
    d, t = split_features_dm.shape
    if d > MAX_DEPTH:
        raise ValueError(f"leaf_index_dm takes depth <= {MAX_DEPTH}, got {d}")
    out = torch.empty((n, t), dtype=torch.int32, device=bins.device)
    if n and t:
        u8 = bins.dtype == torch.uint8
        plan = index_plan(n, t, d, f, 1 if u8 else 4)
        if _TRACER.enabled:
            _TRACER.annotate(**plan_attrs(plan))
        _build.launch("repro_leaf_index_dm", bins.device, bins,
                      split_features_dm, split_bins_dm, pow2, out, n, f, t,
                      d, int(u8), plan.tile.rows,
                      int(plan.tile.route == "global"), plan.n_tree_groups,
                      plan.rounds_per_group)
        leaf_index_dm.launches += 1
    return out


leaf_index_dm.launches = 0

def leaf_index_bp(bins: torch.Tensor, split_features_bp: torch.Tensor,
                  split_bins_bp: torch.Tensor) -> torch.Tensor:
    """idx[n, t] = OR_d [bins[n, sf_bp[d, t]] >= sb_bp[d, t]] << d ->
    (N, T) int32, from the bitpacked (D, T) planes: int32 split features
    and uint8 or int32 thresholds.  Every split feature must lie in
    [0, F).

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the kernel (and adds one to `leaf_index_bp.launches`)."""
    _check_index_args("leaf_index_bp", bins,
                      (split_features_bp, split_bins_bp))
    if split_bins_bp.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"split_bins_bp is int32 or uint8, not "
                         f"{split_bins_bp.dtype}")
    if bins.device.type == "cpu":
        return ref.leaf_index_bitpacked(bins, split_features_bp,
                                        split_bins_bp)
    _build.check_cuda_tensors(
        "leaf_index_bp", bins=(bins, bins.dtype),
        split_features_bp=(split_features_bp, torch.int32),
        split_bins_bp=(split_bins_bp, split_bins_bp.dtype))
    n, f = bins.shape
    d, t = split_features_bp.shape
    if d > MAX_DEPTH:
        raise ValueError(f"leaf_index_bp takes depth <= {MAX_DEPTH}, got {d}")
    out = torch.empty((n, t), dtype=torch.int32, device=bins.device)
    if n and t:
        u8 = bins.dtype == torch.uint8
        plan = bp_plan(n, t, d, f, 1 if u8 else 4)
        if _TRACER.enabled:
            _TRACER.annotate(**plan_attrs(plan))
        _build.launch("repro_leaf_index_bp", bins.device, bins,
                      split_features_bp, split_bins_bp, out, n, f, t, d,
                      int(u8), int(split_bins_bp.dtype == torch.uint8),
                      plan.tile.stride, int(plan.tile.route == "global"),
                      plan.n_tree_groups, plan.rounds_per_group)
        leaf_index_bp.launches += 1
    return out


leaf_index_bp.launches = 0
