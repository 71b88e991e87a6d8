"""Fused binarize -> leaf index -> leaf gather on Hopper.

Three kernels, one for each way a layout holds its splits:

  fused_predict     `csrc/fused_predict.cu`: (T, D) splits (soa);
                    replaces `src/repro/kernels/fused_predict.py:
                    fused_predict`.  Plain version `ref.fused_predict`.
  fused_predict_dm  `csrc/fused_predict_dm.cu`: (D, T) planes and level
                    weights (depth_major); replaces `fused_predict_dm`.
                    Plain version `ref.fused_predict_depth_major`.
  fused_predict_bp  `csrc/fused_predict_bp.cu`: (D, T) planes with uint8
                    or int32 thresholds (bitpacked, one depth group);
                    replaces `fused_predict_bp`.  Plain version
                    `ref.fused_predict_bitpacked`.

All three sum the trees in order, one add per tree, as `leaf_gather`
does, so every route of one model gives bit-identical scores.  They take
any number of outputs (a block walks its rows' output slabs in turn) and
any number of features (`tuning.tile_shape`: the bins tile in shared
memory up to the opt-in limit, an (N, F) scratch array past it).

Each kernel has two routes, which `tuning.fused_plan` picks from the
shape (`route=` forces one): `row`, a thread a row walking every tree,
128 rows a block, for many rows; and `spread` (`csrc/fused_spread.cuh`,
one source for the three layouts), for a serving bucket, whose blocks
take N // 132 rows each (one at a 16-row bucket, 7 at 1,024) so the
bucket fills the card, and walk the trees in chunks: the block's threads
index a chunk's (row, tree) pairs, copy its leaf values into shared
memory asynchronously, and lanes over (row, output) add them in tree
order while the next chunk's copies are in flight.  Spread takes a shape
only where its rows of bins fit shared memory; no route falls back to
another.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.leaf_index import MAX_DEPTH
from repro_torch.kernels.tuning import fused_plan, output_slabs, tile_shape


def _launch_args(x: torch.Tensor, n_borders: int, c: int, planes: bool
                 ) -> tuple:
    """(bins_u8, stride, rows a block, scratch, slab) of a launch: the
    tile of `tuning.tile_shape`; on its global route an (N, F) scratch
    array that stage 1 writes the bins to (None on the shared route);
    the width of the output slabs the block walks in turn."""
    n, f = x.shape
    u8 = n_borders <= ref.MAX_U8_BORDERS
    plan = tile_shape(f, u8, planes)
    scratch = None
    if plan.route == "global":
        scratch = torch.empty((n, f), device=x.device,
                              dtype=torch.uint8 if u8 else torch.int32)
    slab = output_slabs(c)[0]
    return int(u8), plan.stride, plan.rows, scratch, slab[1] - slab[0]


def _check_route(route: str | None) -> None:
    if route not in (None, "spread", "row"):
        raise ValueError(f"route is spread, row or None, not {route!r}")


def _check_fused_args(name: str, x, borders, planes, leaf_values,
                      n_trees: int, depth: int) -> None:
    if x.ndim != 2 or borders.ndim != 2 or x.shape[1] != borders.shape[1] \
            or any(p.ndim != 2 or p.shape != planes[0].shape
                   for p in planes) \
            or leaf_values.ndim != 3 or leaf_values.shape[0] != n_trees:
        raise ValueError(
            f"{name} takes x (N, F), borders (B, F), split arrays of one "
            f"2-d shape and leaf values (T, L, C), got {tuple(x.shape)}, "
            f"{tuple(borders.shape)}, {[tuple(p.shape) for p in planes]} "
            f"and {tuple(leaf_values.shape)}")
    if x.device.type == "cpu":
        return
    if depth > MAX_DEPTH or leaf_values.shape[1] != 1 << depth:
        raise ValueError(f"{name} takes depth <= {MAX_DEPTH} with 2^depth "
                         f"leaves, got depth {depth} and "
                         f"{leaf_values.shape[1]} leaves")


def fused_predict(x: torch.Tensor, borders: torch.Tensor,
                  split_features: torch.Tensor, split_bins: torch.Tensor,
                  leaf_values: torch.Tensor, route: str | None = None
                  ) -> torch.Tensor:
    """Fused GBDT predict -> (N, C) float32 raw tree sums.

    The bins of a row block stay on chip, as uint8 when B <= 255 and as
    int32 otherwise.  `route` ("spread" or "row") forces one of the
    kernel's routes; None lets `tuning.fused_plan` pick.  A tensor on the
    CPU goes through the plain version; a CUDA tensor launches the kernel
    (and adds one to `fused_predict.launches`)."""
    _check_fused_args("fused_predict", x, borders,
                      (split_features, split_bins), leaf_values,
                      *split_features.shape)
    _check_route(route)
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
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n and c:
        u8 = n_borders <= ref.MAX_U8_BORDERS
        plan = fused_plan(n, t, d, c, f, u8, route)
        if plan.route == "spread":
            _build.launch("repro_fused_predict_spread", x.device, x,
                          borders, split_features, split_bins, leaf_values,
                          out, n, f, n_borders, t, d, c, int(u8), plan.rows,
                          plan.threads, plan.trees_per_chunk, plan.slab)
        else:
            u8, stride, rows, scratch, slab = _launch_args(x, n_borders, c,
                                                           False)
            _build.launch("repro_fused_predict", x.device, x, borders,
                          split_features, split_bins, leaf_values, out,
                          scratch, n, f, n_borders, t, d, c, u8, stride,
                          rows, slab)
        fused_predict.launches += 1
    return out


fused_predict.launches = 0


def fused_predict_dm(x: torch.Tensor, borders: torch.Tensor,
                     split_features_dm: torch.Tensor,
                     split_bins_dm: torch.Tensor, pow2: torch.Tensor,
                     leaf_values: torch.Tensor, route: str | None = None
                     ) -> torch.Tensor:
    """Fused GBDT predict over the depth-major (D, T) int32 planes and
    (D, 1) f32 level weights -> (N, C) float32 raw tree sums.

    `route` ("spread" or "row") forces one of the kernel's routes; None
    lets `tuning.fused_plan(..., splits="planes")` pick.  A tensor on the
    CPU goes through the plain version; a CUDA tensor launches the kernel
    (and adds one to `fused_predict_dm.launches`)."""
    d, t = split_features_dm.shape
    _check_fused_args("fused_predict_dm", x, borders,
                      (split_features_dm, split_bins_dm), leaf_values, t, d)
    _check_route(route)
    if pow2.shape != (d, 1):
        raise ValueError(f"pow2 must be (D, 1) = ({d}, 1), got "
                         f"{tuple(pow2.shape)}")
    if x.device.type == "cpu":
        return ref.fused_predict_depth_major(x, borders, split_features_dm,
                                             split_bins_dm, pow2,
                                             leaf_values)
    _build.check_cuda_tensors(
        "fused_predict_dm", x=(x, torch.float32),
        borders=(borders, torch.float32),
        split_features_dm=(split_features_dm, torch.int32),
        split_bins_dm=(split_bins_dm, torch.int32),
        pow2=(pow2, torch.float32), leaf_values=(leaf_values, torch.float32))
    n, f = x.shape
    n_borders = borders.shape[0]
    c = leaf_values.shape[2]
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n and c:
        u8 = n_borders <= ref.MAX_U8_BORDERS
        plan = fused_plan(n, t, d, c, f, u8, route, splits="planes")
        if plan.route == "spread":
            _build.launch("repro_fused_predict_dm_spread", x.device, x,
                          borders, split_features_dm, split_bins_dm, pow2,
                          leaf_values, out, n, f, n_borders, t, d, c,
                          int(u8), plan.rows, plan.threads,
                          plan.trees_per_chunk, plan.slab)
        else:
            u8, stride, rows, scratch, slab = _launch_args(x, n_borders, c,
                                                           True)
            _build.launch("repro_fused_predict_dm", x.device, x, borders,
                          split_features_dm, split_bins_dm, pow2,
                          leaf_values, out, scratch, n, f, n_borders, t, d,
                          c, u8, stride, rows, slab)
        fused_predict_dm.launches += 1
    return out


fused_predict_dm.launches = 0


def fused_predict_bp(x: torch.Tensor, borders: torch.Tensor,
                     split_features_bp: torch.Tensor,
                     split_bins_bp: torch.Tensor,
                     leaf_values: torch.Tensor, route: str | None = None
                     ) -> torch.Tensor:
    """Fused GBDT predict over the bitpacked (D, T) planes (int32 split
    features, uint8 or int32 thresholds) -> (N, C) float32 raw tree sums.

    `route` ("spread" or "row") forces one of the kernel's routes; None
    lets `tuning.fused_plan(..., splits="bitpacked")` pick.  A tensor on
    the CPU goes through the plain version; a CUDA tensor launches the
    kernel (and adds one to `fused_predict_bp.launches`)."""
    d, t = split_features_bp.shape
    _check_fused_args("fused_predict_bp", x, borders,
                      (split_features_bp, split_bins_bp), leaf_values, t, d)
    _check_route(route)
    if split_bins_bp.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"split_bins_bp is int32 or uint8, not "
                         f"{split_bins_bp.dtype}")
    if x.device.type == "cpu":
        return ref.fused_predict_bitpacked(x, borders, split_features_bp,
                                           split_bins_bp, leaf_values)
    _build.check_cuda_tensors(
        "fused_predict_bp", x=(x, torch.float32),
        borders=(borders, torch.float32),
        split_features_bp=(split_features_bp, torch.int32),
        split_bins_bp=(split_bins_bp, split_bins_bp.dtype),
        leaf_values=(leaf_values, torch.float32))
    n, f = x.shape
    n_borders = borders.shape[0]
    c = leaf_values.shape[2]
    planes_u8 = int(split_bins_bp.dtype == torch.uint8)
    out = torch.empty((n, c), dtype=torch.float32, device=x.device)
    if n and c:
        u8 = n_borders <= ref.MAX_U8_BORDERS
        plan = fused_plan(n, t, d, c, f, u8, route, splits="bitpacked")
        if plan.route == "spread":
            _build.launch("repro_fused_predict_bp_spread", x.device, x,
                          borders, split_features_bp, split_bins_bp,
                          leaf_values, out, n, f, n_borders, t, d, c,
                          int(u8), planes_u8, plan.rows, plan.threads,
                          plan.trees_per_chunk, plan.slab)
        else:
            u8, stride, rows, scratch, slab = _launch_args(x, n_borders, c,
                                                           True)
            _build.launch("repro_fused_predict_bp", x.device, x, borders,
                          split_features_bp, split_bins_bp, leaf_values, out,
                          scratch, n, f, n_borders, t, d, c, u8, planes_u8,
                          stride, rows, slab)
        fused_predict_bp.launches += 1
    return out


fused_predict_bp.launches = 0
