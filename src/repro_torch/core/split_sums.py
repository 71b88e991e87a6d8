"""The split search's float sums, in the order the JAX package's compiled
trainer adds them, so that exact gain ties resolve as they do there.

`gain[f, b]` sums a term over every (leaf, stat).  When two candidate
splits leave the same partition (a level that repeats an earlier split
does), their gains are equal in exact arithmetic and f32 rounding picks
the winner.  The port therefore reproduces the two orders XLA's CPU
backend uses inside the JAX package's jitted split step
(`src/repro/training/gbdt.py: _split_level`, and `_build_tree` in
`src/repro/core/boosting.py`):

* `blocked_cumsum`, the inclusive scan over bins (and over rows in
  ordered boosting).  XLA rewrites `jnp.cumsum` (a reduce-window as long
  as the axis) into 16-element blocks: each block is scanned in order,
  the block totals are scanned the same way, and each element adds the
  earlier blocks' total.
* `leaf_stat_sum`, the reduce over (leaf, stat).  XLA emits it as a loop
  over leaves (stats inner) that LLVM vectorizes with reassociation
  (`fastmath<reassoc>`) where its cost model finds it worth it: `lanes`
  accumulators take leaves round robin, the lanes are added in halves,
  and the last leaves (a scalar epilogue) are added in order.  Past 32
  leaves XLA first sums windows of 32 consecutive leaves, all their
  stats (its tree-reduction rewrite, a reduce-window kernel of its own):
  in order, or, where a leaf's bins and stats span at most 8 floats, in
  8 lanes with the window's last 8 leaves as the epilogue; then it
  reduces the window sums in order.  Which of these it does depends on
  the shape; `leaf_sum_plan` holds the choices, read from the compiled
  code by `scripts/split_order_probe.py` on an x86-64 host with AVX-512.

Every chain of dependent adds is one sequential scan (`sequential_scan`):
f32 adds in order, down the first axis, over every other axis at once.
On the card that is `torch.cumsum` along a leading axis, whose CUDA
kernel gives each column a thread that adds in order in the tensor's
dtype; on the CPU it is numpy's `cumsum` of float32, which does the same
(torch's CPU scan accumulates in double).  So a level's split search is
a few launches whatever its leaves and stats, and the card gives the
CPU's bits (`chip_smoke.py` holds it to them).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SCAN_BLOCK = 16         # XLA's reduce-window rewrite: elements a block
LEAF_WINDOW = 32        # XLA's tree-reduction rewrite: leaves a window
NEG_INF = -1e30         # the gain of a masked split


def sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of `x` (ndim >= 2) down its first axis: each column
    adds in order in float32, on the card and on the CPU alike."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.cumsum(x.contiguous().numpy(), axis=0))
    return torch.cumsum(x.contiguous(), dim=0)


def blocked_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive scan of `x` along `dim` in XLA's order: in order within
    blocks of `SCAN_BLOCK`, then each block adds the total of the blocks
    before it, itself scanned so (in order up to `SCAN_BLOCK` blocks,
    blocked again past that).  Exact to `jnp.cumsum` on the CPU at every
    length tried, 1 to 1,000,003."""
    moved = x.movedim(dim, 0)
    rest = moved.shape[1:]
    flat = _scan_first(moved.reshape(moved.shape[0], -1))
    return flat.reshape(flat.shape[0], *rest).movedim(0, dim)


def _scan_first(x: torch.Tensor) -> torch.Tensor:
    """`blocked_cumsum` of (n, M) `x` down its rows."""
    n = x.shape[0]
    n_blocks = -(-n // SCAN_BLOCK)
    if n_blocks * SCAN_BLOCK != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, n_blocks * SCAN_BLOCK - n))
    inner = sequential_scan(x.view(n_blocks, SCAN_BLOCK, -1)
                            .transpose(0, 1))              # (16, nb, M)
    if n_blocks > 1:
        totals = inner[-1]                                  # (nb, M)
        scanned = (sequential_scan(totals) if n_blocks <= SCAN_BLOCK
                   else _scan_first(totals))
        carry = torch.nn.functional.pad(scanned[:-1], (0, 0, 1, 0))
        inner = inner + carry[None]
    return inner.transpose(0, 1).reshape(n_blocks * SCAN_BLOCK, -1)[:n]


@dataclasses.dataclass(frozen=True)
class LeafSumPlan:
    """How XLA adds a (leaf, stat) reduce: `windows` rounds of sums over
    `LEAF_WINDOW` consecutive leaves, then `lanes` accumulators over the
    first `vector_leaves` leaves (1 lane: none), the lanes added in
    halves, then the rest in order.  A window adds its leaves (stats
    inner) in order, or, with `window_lanes` > 1 on the first round, as
    LLVM vectorized it where a window's interleaved loads are narrow:
    `window_lanes` accumulators over all but its last `window_lanes`
    leaves, added in halves, then those leaves in order."""
    windows: int = 0
    lanes: int = 1
    vector_leaves: int = 0
    window_lanes: int = 1


def _table(spec: str) -> frozenset[int]:
    out: set[int] = set()
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return frozenset(out)


# Past 32 leaves: stats -> the bin counts whose first window round runs
# in 8 lanes (the window's loads interleave at most 8 floats a leaf);
# read by scripts/split_order_probe.py at 64 to 2,048 leaves.
_WINDOW_LANES: dict[int, frozenset] = {
    2: _table("2-4"), 3: _table("2"), 4: _table("2")}
WINDOW_LANES = 8

# (leaves, stats) -> {(lanes, epilogue leaves): the bin counts it holds
# for}; any other bin count adds in order.  Read from the compiled JAX
# split step by scripts/split_order_probe.py (bins 2..256).
_VECTORIZED: dict[tuple[int, int], dict[tuple[int, int], frozenset]] = {
    (4, 2): {(4, 0): _table("2-16")},
    (8, 2): {(8, 0): _table("2-16")},
    (16, 1): {(8, 8): _table("2-4,17-48"),
              (8, 0): _table("5-16,64,112,128,240,256")},
    (16, 2): {(8, 8): _table("2"), (8, 0): _table("3-16")},
    (32, 1): {(8, 8): _table("2-4,17-48"), (8, 0): _table("5-16"),
              (16, 0): _table("64,112,128,240,256")},
    (32, 2): {(8, 8): _table("2"), (8, 0): _table("3-16")},
}


def leaf_sum_plan(n_leaves: int, n_bins: int, n_stats: int) -> LeafSumPlan:
    """XLA's order for the reduce over (n_leaves, n_stats) at n_bins."""
    windows = 0
    while n_leaves > LEAF_WINDOW:
        n_leaves //= LEAF_WINDOW
        windows += 1
    if windows:
        lanes = WINDOW_LANES if n_bins in _WINDOW_LANES.get(n_stats, ()) \
            else 1
        return LeafSumPlan(windows=windows, window_lanes=lanes)
    for (lanes, tail), bins in _VECTORIZED.get((n_leaves, n_stats),
                                               {}).items():
        if n_bins in bins:
            return LeafSumPlan(lanes=lanes, vector_leaves=n_leaves - tail)
    return LeafSumPlan()


def leaf_stat_sum(t: torch.Tensor,
                  plan: Optional[LeafSumPlan] = None) -> torch.Tensor:
    """(F, L, B, C) terms -> (F, B): the sum over leaves and stats in the
    order of `plan` (`leaf_sum_plan` of the shape by default)."""
    n_feat, n_leaves, n_bins, n_stats = t.shape
    if plan is None:
        plan = leaf_sum_plan(n_leaves, n_bins, n_stats)
    for level in range(plan.windows):
        n_leaves //= LEAF_WINDOW
        # (window leaf, stat) in order, for every (F, L', B) at once
        w = t.view(n_feat, n_leaves, LEAF_WINDOW, n_bins, n_stats) \
            .permute(2, 4, 0, 1, 3)                   # (32, S, F, L', B)
        k = plan.window_lanes if level == 0 else 1
        head = None
        if k > 1:
            # lane j: window leaves j, j + k, ... of the first 32 - k
            nv = LEAF_WINDOW - k
            v = w[:nv].reshape(nv // k, k, n_stats, n_feat, n_leaves,
                               n_bins).transpose(1, 2)
            acc = sequential_scan(v.reshape(nv // k * n_stats, k, n_feat,
                                            n_leaves, n_bins))[-1]
            while k > 1:
                k //= 2
                acc = acc[:k] + acc[k:2 * k]
            head, w = acc, w[nv:]   # (1, F, L', B)
        rest = w.reshape(-1, n_feat, n_leaves, n_bins)
        if head is not None:
            rest = torch.cat([head, rest])
        t, n_stats = sequential_scan(rest)[-1][..., None], 1  # (F, L', B, 1)
    out: Optional[torch.Tensor] = None
    nv, lanes = plan.vector_leaves, plan.lanes
    if nv:
        # each lane's (iteration, stat) in order, for every lane at once
        v = t[:, :nv].reshape(n_feat, nv // lanes, lanes, n_bins, n_stats) \
            .permute(1, 4, 0, 2, 3).reshape(nv // lanes * n_stats, n_feat,
                                            lanes, n_bins)
        acc = sequential_scan(v)[-1]                        # (F, lanes, B)
        while lanes > 1:
            lanes //= 2
            acc = acc[:, :lanes] + acc[:, lanes:2 * lanes]
        out = acc[:, 0]
    if nv < n_leaves:
        rest = t[:, nv:].permute(1, 3, 0, 2).reshape(
            (n_leaves - nv) * n_stats, n_feat, n_bins)
        if out is not None:
            rest = torch.cat([out[None], rest])
        out = sequential_scan(rest)[-1]
    return out


def gain_term(gs: torch.Tensor, hs: torch.Tensor, l2: float) -> torch.Tensor:
    return gs * gs / (hs + l2)


def level_gains(h4: torch.Tensor, l2: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, L, B, 2C) histogram (g stats, then h) -> the (F, B) gain of
    splitting at each border and whether that split leaves hessian mass
    on both sides.

    Left of border b is `bins < b`: the inclusive scan shifted by one.
    The mass test sums non-negative hessians, whose sum is positive in
    any order, so it keeps torch's own sum."""
    c = h4.shape[-1] // 2
    incl = blocked_cumsum(h4, dim=2)
    total = incl[:, :, -1:, :]
    left = torch.nn.functional.pad(incl[:, :, :-1, :], (0, 0, 1, 0))
    right = total - left
    gain = leaf_stat_sum(gain_term(left[..., :c], left[..., c:], l2)
                         + gain_term(right[..., :c], right[..., c:], l2))
    nonempty = (left[..., c:].sum(dim=(1, 3)) > 0) \
        & (right[..., c:].sum(dim=(1, 3)) > 0)
    return gain, nonempty
