"""The split search of one tree level (the trainer's `_split_level`) on
Hopper.

The kernel is `csrc/split_level.cu`: three launches a level, no host
synchronization, f* and b* left on the card.  No TPU kernel stands behind
it: in the JAX package this step is plain `jnp`
(`src/repro/training/gbdt.py: _split_level`).  Its plain version is
`split_level_plain`, the JAX package's gain math with its float sums in
the order of its compiled split step (`core.split_sums`); the kernel
adds in the same order, so it gives the plain version's bits.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, tuning
from repro_torch.obs.trace import get_tracer

_TRACER = get_tracer()

# Kernels the launcher starts a level: terms, choose, refine.
KERNELS_A_LEVEL = 3


def split_level_plain(hist, valid, bins_t, leaf, *, n_bins, d, l2,
                      return_gains=False):
    """Pick the level's oblivious split from the (F, L * n_bins, 2C)
    histogram and refine the leaf ids -> (f*, b*, leaf ids), and with
    `return_gains` the (F, n_bins) masked gains too.

    A split needs hessian mass on both sides; when every gain is masked,
    argmax gives (0, 0) and every sample goes right.  argmax takes the
    first maximum over (F, n_bins) flattened in that order, so gains
    that tie exactly resolve as in JAX."""
    from repro_torch.core import split_sums   # core imports the kernels
    n_feat, segments, c2 = hist.shape
    gain, nonempty = split_sums.level_gains(
        hist.view(n_feat, segments // n_bins, n_bins, c2), l2)
    gain = torch.where(valid & nonempty, gain, split_sums.NEG_INF)
    flat = torch.argmax(gain.reshape(-1))
    f_star = torch.div(flat, n_bins, rounding_mode="floor").to(torch.int32)
    b_star = (flat % n_bins).to(torch.int32)
    column = bins_t.index_select(0, f_star.view(1).long())[0]
    go_right = (column.to(torch.int32) >= b_star).to(torch.int32)
    out = (f_star, b_star, leaf | (go_right << d))
    return out + (gain,) if return_gains else out


def _check(hist, valid, bins_t, leaf, n_bins, d):
    if hist.ndim != 3 or valid.ndim != 2 or bins_t.ndim != 2 \
            or leaf.ndim != 1:
        raise ValueError(
            f"split_level takes hist (F, L * B, 2C), valid (F, B), bins_t "
            f"(F, N) and leaf (N,), got {tuple(hist.shape)}, "
            f"{tuple(valid.shape)}, {tuple(bins_t.shape)} and "
            f"{tuple(leaf.shape)}")
    n_feat, segments, c2 = hist.shape
    if n_bins < 1 or n_feat < 1 or c2 < 2 or c2 % 2 or segments % n_bins \
            or not segments:
        raise ValueError(f"split_level: hist {tuple(hist.shape)} is not "
                         f"(F >= 1, L * {n_bins}, 2C >= 2)")
    if tuple(valid.shape) != (n_feat, n_bins) \
            or bins_t.shape[0] != n_feat \
            or leaf.shape[0] != bins_t.shape[1]:
        raise ValueError(
            f"split_level: valid {tuple(valid.shape)}, bins_t "
            f"{tuple(bins_t.shape)} and leaf {tuple(leaf.shape)} do not "
            f"match hist {tuple(hist.shape)} at {n_bins} bins")
    if bins_t.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"bins are uint8 or int32, not {bins_t.dtype}")
    if not 0 <= d <= 30:
        raise ValueError(f"split_level: level {d} outside 0..30")


@functools.lru_cache(maxsize=256)
def _launch_args(n_feat: int, n_leaves: int, n_bins: int, n_out: int,
                 n: int, d: int, u8: int, l2: float):
    """The level's plan and the launcher's arguments after its pointers,
    as ctypes values: built once a shape, as the trainer sends the same
    few shapes every tree."""
    from repro_torch.core import split_sums   # core imports the kernels
    sums = split_sums.leaf_sum_plan(n_leaves, n_bins, n_out)
    if n_leaves % split_sums.LEAF_WINDOW ** sums.windows:
        raise ValueError(f"split_level: {n_leaves} leaves do not split "
                         f"into {sums.windows} rounds of windows of "
                         f"{split_sums.LEAF_WINDOW}")
    plan = tuning.split_plan(n_feat, n_leaves, n_bins, n_out, n,
                             sums.windows)
    if plan.terms_smem > tuning.SPLIT_TERMS_SMEM \
            or n_feat * n_bins >= 2 ** 31:
        raise ValueError(f"split_level: {n_bins} bins x {n_feat} features "
                         "is past the kernel's scan and index range")
    return plan, _build.fixed_args(
        "repro_split_level", 8, n, n_feat, n_leaves, n_bins, n_out, d, u8,
        plan.pairs_per_block, plan.choose_blocks, plan.refine_blocks,
        int(plan.staged), sums.windows, sums.lanes, sums.vector_leaves,
        sums.window_lanes, l2)


def split_level(hist: torch.Tensor, valid: torch.Tensor,
                bins_t: torch.Tensor, leaf: torch.Tensor, *, n_bins: int,
                d: int, l2: float, return_gains: bool = False):
    """(F, L * n_bins, 2C) f32 level histogram (gradients, then
    hessians), (F, n_bins) bool valid borders, (F, N) uint8|int32
    feature-major bins, (N,) int32 leaf ids below 2^d -> (f*, b*) as
    0-dim int32 tensors and the (N,) int32 refined leaf ids; with
    `return_gains`, the (F, n_bins) f32 masked gains as well.

    A tensor on the CPU goes through the plain version; a CUDA tensor
    launches the kernel (and adds one to `split_level.launches`).  While
    the tracer is on, the `dispatch/split_level` span gets the level's
    `launches` on the card."""
    _check(hist, valid, bins_t, leaf, n_bins, d)
    if hist.device.type == "cpu":
        return split_level_plain(hist, valid, bins_t, leaf, n_bins=n_bins,
                                 d=d, l2=l2, return_gains=return_gains)
    _build.check_cuda_tensors("split_level", hist=(hist, torch.float32),
                              valid=(valid, torch.bool),
                              bins_t=(bins_t, bins_t.dtype),
                              leaf=(leaf, torch.int32))
    n_feat, segments, c2 = hist.shape
    plan, tail = _launch_args(n_feat, segments // n_bins, n_bins, c2 // 2,
                              bins_t.shape[1], d,
                              int(bins_t.dtype == torch.uint8), float(l2))
    if _TRACER.enabled:
        _TRACER.annotate(launches=KERNELS_A_LEVEL)
    # four allocations and no view: a traced level records few host ops
    dev = hist.device
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8,
                          device=dev)
    out = torch.empty(leaf.shape, dtype=torch.int32, device=dev)
    f_star = torch.empty((), dtype=torch.int32, device=dev)
    b_star = torch.empty((), dtype=torch.int32, device=dev)
    _build.launch("repro_split_level", dev, hist, valid, bins_t, leaf,
                  scratch, out, f_star, b_star, *tail)
    split_level.launches += 1
    if not return_gains:
        return f_star, b_star, out
    gains = scratch[plan.gains_offset:plan.gains_offset + 4 * n_feat * n_bins]
    return (f_star, b_star, out,
            gains.view(torch.float32).view(n_feat, n_bins))


split_level.launches = 0
