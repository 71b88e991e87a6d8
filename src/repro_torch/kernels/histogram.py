"""Gradient histogram of one tree level (the training hot loop) on Hopper.

The kernel is `csrc/histogram.cu`; it replaces the TPU kernel
`src/repro/kernels/histogram.py:histogram`.  Its plain version is
`ref.histogram`; `ref.histogram_fixed` is its exact function (the same
bits on the card).  The kernel accumulates in 64-bit fixed point, so it
gives the same bits on every launch; its tiling comes from
`tuning.hist_plan`.  Past 64 stats it runs once a stat group: the
fixed-point scale is per stat, so each group's cells are the bits of the
whole.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, tuning
from repro_torch.obs.trace import get_tracer, plan_attrs

_TRACER = get_tracer()


def histogram(bins_t: torch.Tensor, leaf: torch.Tensor, g: torch.Tensor, *,
              n_bins: int, n_leaves: int) -> torch.Tensor:
    """(F, N) uint8|int32 feature-major bins, (N,) int32 leaf ids in
    [0, n_leaves), (N, S) f32 finite stats -> (F, n_leaves * n_bins, S)
    f32 sums per (feature, leaf, bin).

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the kernel (and adds one to `histogram.launches`)."""
    if bins_t.ndim != 2 or leaf.ndim != 1 or g.ndim != 2 \
            or leaf.shape[0] != bins_t.shape[1] \
            or g.shape[0] != bins_t.shape[1]:
        raise ValueError(f"histogram takes bins_t (F, N), leaf (N,) and g "
                         f"(N, S), got {tuple(bins_t.shape)}, "
                         f"{tuple(leaf.shape)} and {tuple(g.shape)}")
    if bins_t.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"bins are uint8 or int32, not {bins_t.dtype}")
    if n_bins < 1 or n_leaves < 1:
        raise ValueError(f"need n_bins >= 1 and n_leaves >= 1, got "
                         f"{n_bins} and {n_leaves}")
    if bins_t.device.type == "cpu":
        return ref.histogram(bins_t, leaf, g, n_bins=n_bins,
                             n_leaves=n_leaves)
    _build.check_cuda_tensors("histogram", bins_t=(bins_t, bins_t.dtype),
                              leaf=(leaf, torch.int32),
                              g=(g, torch.float32))
    f, n = bins_t.shape
    s = g.shape[1]
    plan = tuning.hist_plan(f, n, n_leaves, n_bins, s)
    if _TRACER.enabled:
        _TRACER.annotate(**plan_attrs(plan))
    if max(plan.n_groups, plan.n_tiles) > tuning.GRID_DIM_LIMIT:
        raise ValueError(f"histogram grid too large: {plan.n_groups} "
                         f"feature groups x {plan.n_tiles} tiles (each <= "
                         f"{tuning.GRID_DIM_LIMIT:,})")
    dev = bins_t.device
    out = torch.empty((f, n_leaves * n_bins, s), dtype=torch.float32,
                      device=dev)
    if not (f and n):
        return out.zero_()
    groups = plan.stat_groups
    width = max(stop - start for start, stop in groups)
    max_bits = torch.empty((width,), dtype=torch.int32, device=dev)
    acc = torch.empty((1 if plan.direct else f * n_leaves * n_bins * width,),
                      dtype=torch.int64, device=dev)
    for start, stop in groups:
        part = out if len(groups) == 1 else torch.empty(
            (f, n_leaves * n_bins, stop - start), dtype=torch.float32,
            device=dev)
        g_part = g if len(groups) == 1 else g[:, start:stop].contiguous()
        _build.launch("repro_histogram", dev, bins_t, leaf, g_part, max_bits,
                      acc, part, n, f, n_bins, n_leaves, stop - start,
                      int(bins_t.dtype == torch.uint8), plan.seg_tile,
                      plan.feats_per_block, plan.row_chunks)
        histogram.launches += 1
        if part is not out:
            out[:, :, start:stop] = part
    return out


histogram.launches = 0
