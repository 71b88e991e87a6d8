"""Physical ensemble layouts: the lowering step between Predictor plans and
kernels.

The port's counterpart of `src/repro/core/layout.py`.  A logical
`ObliviousEnsemble` is lowered once, at `Predictor.build`, into one of
four layouts whose arrays a kernel family reads as they are:

  soa            (T, D) splits and one (T, 2^Dmax, C) leaf table; with
                 `tree_block`, the staged path walks pre-cut tree blocks
                 (the paper's CalcTreesBlockedImpl).
  depth_major    splits transposed to (D, T) planes beside the per-level
                 weights pow2 (the paper's hoisted pow2 vector).  The JAX
                 package also lowers a (T, D, F) f32 one-hot for its MXU
                 gather; the port's kernels read the bins at the split
                 feature directly, so it lowers the (D, T) int32
                 `split_features_dm` in the one-hot's place.
  depth_grouped  trees bucketed by true depth, a depth-d tree carrying a
                 2^d leaf table, evaluated group by group through the soa
                 kernels and summed (the group sums reassociate the float
                 tree sum).
  bitpacked      the depth groups with (d, T_d) planes, thresholds uint8
                 where every one fits a byte: the paper's word-packed
                 compare loop (32 rows' compare bits in one word).

Every kernel masks its own edges, so lowering pads nothing: a CUDA plan
and a CPU plan hold the same arrays, and each equals the JAX package's
`lower(..., backend="ref")` (the one-hot aside).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class SoaLayout:
    """Structure of arrays with one shared depth."""
    layout_name = "soa"
    borders: torch.Tensor           # (B, F) f32
    split_features: torch.Tensor    # (T, D) i32
    split_bins: torch.Tensor        # (T, D) i32
    leaf_values: torch.Tensor       # (T, L, C) f32
    # staged tree blocking: (sf, sb, lv) slices per block, cut at lowering
    tree_blocks: Optional[tuple] = None
    n_outputs: int = 1

    def leaf_sum(self, bins: torch.Tensor, *, backend: str) -> torch.Tensor:
        """Staged leaf index + leaf gather from bins -> (N, C)."""
        if self.tree_blocks is not None:
            acc = torch.zeros((bins.shape[0], self.n_outputs),
                              dtype=torch.float32, device=bins.device)
            for sf, sb, lv in self.tree_blocks:
                idx = ops.leaf_index_prepadded(bins, sf, sb, backend=backend)
                acc = acc + ops.leaf_gather_prepadded(idx, lv,
                                                      backend=backend)
            return acc
        idx = ops.leaf_index_prepadded(bins, self.split_features,
                                       self.split_bins, backend=backend)
        return ops.leaf_gather_prepadded(idx, self.leaf_values,
                                         backend=backend)

    def fused_raw(self, x: torch.Tensor, *, backend: str) -> torch.Tensor:
        return ops.fused_predict_prepadded(
            x, self.borders, self.split_features, self.split_bins,
            self.leaf_values, backend=backend)

    def leaf_table_bytes(self) -> int:
        return int(np.prod(self.leaf_values.shape)) * 4

    def describe(self) -> dict[str, Any]:
        return {"layout": self.layout_name,
                "leaf_table_bytes": self.leaf_table_bytes(),
                "trees": int(self.split_features.shape[0]),
                "tree_blocks": (len(self.tree_blocks)
                                if self.tree_blocks else 0)}


@dataclasses.dataclass(frozen=True)
class DepthMajorLayout:
    """(D, T) split planes and the per-level weights 2^d."""
    layout_name = "depth_major"
    borders: torch.Tensor           # (B, F) f32
    split_features_dm: torch.Tensor  # (D, T) i32
    split_bins_dm: torch.Tensor     # (D, T) i32
    pow2: torch.Tensor              # (D, 1) f32
    leaf_values: torch.Tensor       # (T, L, C) f32
    n_outputs: int = 1

    def leaf_sum(self, bins: torch.Tensor, *, backend: str) -> torch.Tensor:
        idx = ops.leaf_index_dm_prepadded(bins, self.split_features_dm,
                                          self.split_bins_dm, self.pow2,
                                          backend=backend)
        return ops.leaf_gather_prepadded(idx, self.leaf_values,
                                         backend=backend)

    def fused_raw(self, x: torch.Tensor, *, backend: str) -> torch.Tensor:
        return ops.fused_predict_dm_prepadded(
            x, self.borders, self.split_features_dm, self.split_bins_dm,
            self.pow2, self.leaf_values, backend=backend)

    def leaf_table_bytes(self) -> int:
        return int(np.prod(self.leaf_values.shape)) * 4

    def plane_bytes(self) -> int:
        return 4 * (self.split_features_dm.numel()
                    + self.split_bins_dm.numel())

    def describe(self) -> dict[str, Any]:
        return {"layout": self.layout_name,
                "leaf_table_bytes": self.leaf_table_bytes(),
                "plane_bytes": self.plane_bytes()}


@dataclasses.dataclass(frozen=True)
class DepthGroup:
    """All trees of one true depth, sliced to that depth's shapes."""
    depth: int
    split_features: torch.Tensor    # (Tg, d) i32
    split_bins: torch.Tensor        # (Tg, d) i32
    leaf_values: torch.Tensor       # (Tg, 2^d, C) f32

    @property
    def n_trees(self) -> int:
        return self.split_features.shape[0]


def _group_sum(groups, index_fn, bins: torch.Tensor, n_outputs: int,
               backend: str) -> torch.Tensor:
    """Sum of the groups' staged leaf sums, group by group in depth order."""
    acc = torch.zeros((bins.shape[0], n_outputs), dtype=torch.float32,
                      device=bins.device)
    for g in groups:
        idx = index_fn(g, bins)
        acc = acc + ops.leaf_gather_prepadded(idx, g.leaf_values,
                                              backend=backend)
    return acc


def _grouped_leaf_bytes(groups) -> int:
    return sum(int(np.prod(g.leaf_values.shape)) * 4 for g in groups)


@dataclasses.dataclass(frozen=True)
class DepthGroupedLayout:
    """Trees bucketed by true depth; shallow trees carry small tables."""
    layout_name = "depth_grouped"
    borders: torch.Tensor           # (B, F) f32
    groups: tuple                   # DepthGroup, depth ascending
    n_outputs: int = 1

    def leaf_sum(self, bins: torch.Tensor, *, backend: str) -> torch.Tensor:
        return _group_sum(
            self.groups,
            lambda g, b: ops.leaf_index_prepadded(
                b, g.split_features, g.split_bins, backend=backend),
            bins, self.n_outputs, backend)

    def fused_raw(self, x: torch.Tensor, *, backend: str) -> torch.Tensor:
        # One fused launch per group would binarize x once per group:
        # binarize once and run the grouped index + gather instead.
        bins = ops.binarize_prepadded(x, self.borders, backend=backend)
        return self.leaf_sum(bins, backend=backend)

    def leaf_table_bytes(self) -> int:
        return _grouped_leaf_bytes(self.groups)

    def describe(self) -> dict[str, Any]:
        return {"layout": self.layout_name,
                "leaf_table_bytes": self.leaf_table_bytes(),
                "groups": {g.depth: g.n_trees for g in self.groups}}


@dataclasses.dataclass(frozen=True)
class BitpackedGroup:
    """All trees of one true depth, splits as (d, Tg) planes."""
    depth: int
    split_features_bp: torch.Tensor  # (d, Tg) i32
    split_bins_bp: torch.Tensor     # (d, Tg) u8 when thresholds fit, else i32
    leaf_values: torch.Tensor       # (Tg, 2^d, C) f32

    @property
    def n_trees(self) -> int:
        return self.split_features_bp.shape[1]


@dataclasses.dataclass(frozen=True)
class BitpackedLayout:
    """Depth groups with integer (d, Tg) planes: leaf indexes assemble by
    shift/or from one compare bit per row and level."""
    layout_name = "bitpacked"
    borders: torch.Tensor           # (B, F) f32
    groups: tuple                   # BitpackedGroup, depth ascending
    n_outputs: int = 1
    binary_split: bool = False      # every feature has <= 1 border
    n_features: int = 0

    def leaf_sum(self, bins: torch.Tensor, *, backend: str) -> torch.Tensor:
        return _group_sum(
            self.groups,
            lambda g, b: ops.leaf_index_bp_prepadded(
                b, g.split_features_bp, g.split_bins_bp, backend=backend),
            bins, self.n_outputs, backend)

    def fused_raw(self, x: torch.Tensor, *, backend: str) -> torch.Tensor:
        if len(self.groups) == 1:
            g = self.groups[0]
            return ops.fused_predict_bp_prepadded(
                x, self.borders, g.split_features_bp, g.split_bins_bp,
                g.leaf_values, backend=backend)
        # several groups: binarize once, as DepthGroupedLayout does
        bins = ops.binarize_prepadded(x, self.borders, backend=backend)
        return self.leaf_sum(bins, backend=backend)

    def leaf_table_bytes(self) -> int:
        return _grouped_leaf_bytes(self.groups)

    def plane_bytes(self) -> int:
        """Bytes of the split planes (both arrays, all groups)."""
        return sum(g.split_features_bp.numel() * 4
                   + g.split_bins_bp.numel()
                   * g.split_bins_bp.element_size() for g in self.groups)

    def pool_row_bytes(self) -> tuple[int, int]:
        """(uint8 bytes, u1-plane bytes) of one quantized pool row; the u1
        figure holds only for a binary-split schema (`pack_pool_u1`)."""
        f = max(int(self.n_features), 1)
        return f, -(-f // 32) * 4

    def describe(self) -> dict[str, Any]:
        u8, u1 = self.pool_row_bytes()
        return {"layout": self.layout_name,
                "leaf_table_bytes": self.leaf_table_bytes(),
                "plane_bytes": self.plane_bytes(),
                "groups": {g.depth: g.n_trees for g in self.groups},
                "binary_split": self.binary_split,
                "pool_row_bytes_u8": u8,
                "pool_row_bytes_u1": u1,
                "pool_shrink_x": (u8 / u1) if self.binary_split else 1.0}


LoweredEnsemble = (SoaLayout | DepthMajorLayout | DepthGroupedLayout
                   | BitpackedLayout)


# --------------------------------------------------------------------------
# Tree sharding (`Predictor.sharded`)
# --------------------------------------------------------------------------
# T-axis alignment of a tree shard: the JAX package's staged tree block.
# The port's kernels mask their own edges, so nothing needs it; it keeps
# a shard's shapes, and so its launch plans, the JAX package's.
STAGED_TREE_ALIGN = 16


def _shard_bounds(n_trees: int, n_shards: int, t_align: int):
    """(padded total, per-shard size) for an equal T-axis split where
    every shard stays a `t_align` multiple."""
    unit = max(n_shards * max(t_align, 1), 1)
    total = -(-max(n_trees, 1) // unit) * unit
    return total, total // n_shards


def _cut_trees(a: torch.Tensor, axis: int, total: int, n_shards: int,
               value=0) -> list:
    """`a` padded along its tree axis to `total` with `value` and cut into
    `n_shards` equal contiguous slices."""
    a = ops.pad_dim(a, axis, total, value=value)
    per = total // n_shards
    return [a.narrow(axis, k * per, per).contiguous()
            for k in range(n_shards)]


def shard_trees(lowered: LoweredEnsemble, n_shards: int, *,
                t_align: int = 1) -> list:
    """Split a lowered ensemble's tree axis into `n_shards` equal slices
    for tree-sharded evaluation on a mesh.

    Every shard is the same layout class with identical shapes and
    identical static fields, so every shard launches the same grid.
    Slices are padded with *neutral* trees (split feature 0, split bin
    `ops.PAD_SPLIT_BIN`, always left; all-zero leaf rows), so a padded
    tree adds exactly 0.0 and

        sum_k shard_k.leaf_sum(bins)  ==  lowered.leaf_sum(bins)

    up to float reassociation: the partial sums combine in another order
    than the single-device tree loop, so tree-sharded results agree to
    rounding, not bit for bit (row sharding stays exact).

    Grouped layouts (depth_grouped / bitpacked) shard *within* each depth
    group: every shard keeps the full group list (same depths) with 1/K
    of each group's trees.  A uint8 bitpacked plane cannot hold
    `PAD_SPLIT_BIN` and pads 0 (always right): the padded tree then
    lands in its last leaf, whose row is zero all the same.
    """
    if n_shards <= 1:
        return [lowered]
    k = n_shards
    pad = ops.PAD_SPLIT_BIN
    if isinstance(lowered, SoaLayout):
        if lowered.tree_blocks is not None:
            raise ValueError(
                "shard_trees on a tree-blocked soa plan is unsupported: "
                "the block slices were cut for the single-device loop; "
                "lower with tree_block=0 before tree-sharding")
        total, _ = _shard_bounds(lowered.split_features.shape[0], k,
                                 t_align)
        parts = zip(_cut_trees(lowered.split_features, 0, total, k),
                    _cut_trees(lowered.split_bins, 0, total, k, pad),
                    _cut_trees(lowered.leaf_values, 0, total, k))
        return [SoaLayout(lowered.borders, sf, sb, lv, None,
                          n_outputs=lowered.n_outputs)
                for sf, sb, lv in parts]
    if isinstance(lowered, DepthMajorLayout):
        total, _ = _shard_bounds(lowered.split_features_dm.shape[1], k,
                                 t_align)
        parts = zip(_cut_trees(lowered.split_features_dm, 1, total, k),
                    _cut_trees(lowered.split_bins_dm, 1, total, k, pad),
                    _cut_trees(lowered.leaf_values, 0, total, k))
        return [DepthMajorLayout(lowered.borders, sf, sb, lowered.pow2, lv,
                                 n_outputs=lowered.n_outputs)
                for sf, sb, lv in parts]
    if isinstance(lowered, DepthGroupedLayout):
        shard_groups = [[] for _ in range(k)]
        for g in lowered.groups:
            total, _ = _shard_bounds(g.n_trees, k, t_align)
            parts = zip(_cut_trees(g.split_features, 0, total, k),
                        _cut_trees(g.split_bins, 0, total, k, pad),
                        _cut_trees(g.leaf_values, 0, total, k))
            for gs, (sf, sb, lv) in zip(shard_groups, parts):
                gs.append(DepthGroup(g.depth, sf, sb, lv))
        return [DepthGroupedLayout(lowered.borders, tuple(gs),
                                   n_outputs=lowered.n_outputs)
                for gs in shard_groups]
    if isinstance(lowered, BitpackedLayout):
        shard_groups = [[] for _ in range(k)]
        for g in lowered.groups:
            total, _ = _shard_bounds(g.n_trees, k, t_align)
            pad_bin = 0 if g.split_bins_bp.dtype == torch.uint8 else pad
            parts = zip(_cut_trees(g.split_features_bp, 1, total, k),
                        _cut_trees(g.split_bins_bp, 1, total, k, pad_bin),
                        _cut_trees(g.leaf_values, 0, total, k))
            for gs, (sf, sb, lv) in zip(shard_groups, parts):
                gs.append(BitpackedGroup(g.depth, sf, sb, lv))
        return [BitpackedLayout(lowered.borders, tuple(gs),
                                n_outputs=lowered.n_outputs,
                                binary_split=lowered.binary_split,
                                n_features=lowered.n_features)
                for gs in shard_groups]
    raise TypeError(f"shard_trees: unsupported lowered type "
                    f"{type(lowered).__name__}")


def map_arrays(fn, *items):
    """Apply `fn` to the corresponding tensors of like-structured lowered
    ensembles (their groups and tree blocks included) and rebuild the
    first's structure around the results; static fields are the
    first's."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return fn(*items)
    if isinstance(first, tuple):
        return tuple(map_arrays(fn, *parts)
                     for parts in zip(*items, strict=True))
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: map_arrays(fn, *(getattr(it, f.name) for it in items))
            for f in dataclasses.fields(first)
            if isinstance(getattr(first, f.name), (torch.Tensor, tuple))})
    return first


def to_device(lowered: LoweredEnsemble,
              device: torch.device) -> LoweredEnsemble:
    """The lowered ensemble with every array on `device` (itself when
    they are there already)."""
    return map_arrays(lambda a: a.to(device), lowered)


def stack_tree_shards(shards: list):
    """Stack `shard_trees`' shards into one lowered ensemble whose every
    array has a leading shard axis (the JAX package's input to
    `shard_map` with ``P(model_axis)``)."""
    return map_arrays(lambda *xs: torch.stack(xs), *shards)


def unstack_tree_shard(stacked, k: int = 0):
    """Shard `k` of a `stack_tree_shards` result: every array's leading
    shard axis indexed at `k` (a contiguous view).  The default takes the
    unit leading axis the JAX package's mapped body sees."""
    return map_arrays(lambda a: a.select(0, k), stacked)


def pack_pool_u1(bins: torch.Tensor) -> torch.Tensor:
    """Pack a binary-split pool (N, F) of 0/1 bins into u1 feature planes
    -> (N, ceil(F/32)) uint32, ragged feature tails zero.  Valid only when
    every bin is 0 or 1 (`BitpackedLayout.binary_split`)."""
    return ref.pack_bits(bins.t()).t()


def unpack_pool_u1(planes: torch.Tensor, n_features: int) -> torch.Tensor:
    """Inverse of `pack_pool_u1` -> (N, n_features) int32 bins."""
    return ref.unpack_bits(planes.t(), n_features).t()


# --------------------------------------------------------------------------
# Layout registry (capability metadata for docs and tests)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayoutSpec:
    name: str
    cls: type
    paper_analog: str               # which paper mechanism it encodes
    claimed_ops: tuple[str, ...]    # kernel ops the layout needs impls for
    memory: str                     # memory-cost note
    when: str                       # when `auto` picks it


_SERVING_OPS = ("binarize", "leaf_index", "leaf_gather", "fused_predict")

LAYOUTS: dict[str, LayoutSpec] = {
    "soa": LayoutSpec(
        name="soa", cls=SoaLayout,
        paper_analog="CatBoost SoA model arrays (compatibility default)",
        claimed_ops=_SERVING_OPS,
        memory="T x 2^Dmax x C leaf table; (T, D) splits",
        when="uniform models on the CPU; every model on CUDA"),
    "depth_major": LayoutSpec(
        name="depth_major", cls=DepthMajorLayout,
        paper_analog="hoisted pow2 / vmsgeu bit-plane loop (CalcIndexes)",
        claimed_ops=_SERVING_OPS,
        memory="soa leaf table; (D, T) int32 feature and bin planes",
        when="never by auto: on request"),
    "depth_grouped": LayoutSpec(
        name="depth_grouped", cls=DepthGroupedLayout,
        paper_analog="equal-depth tree grouping (CalcTreesBlockedImpl)",
        claimed_ops=_SERVING_OPS,
        memory="sum_d T_d x 2^d x C leaf tables (< soa when depths mix)",
        when="CPU: mixed true depths with enough shallow-tree savings"),
    "bitpacked": LayoutSpec(
        name="bitpacked", cls=BitpackedLayout,
        paper_analog="word-packed comparison loop (vmsgeu mask word + "
                     "integer shift/or index assembly)",
        claimed_ops=_SERVING_OPS,
        memory="grouped leaf tables + 2 x (d, T_d) integer planes; "
               "u1 pool planes when binary-split",
        when="CPU: mixed depths too large for the reference's one-hot"),
}

LAYOUT_NAMES = tuple(LAYOUTS)


def format_layout_table() -> str:
    """The layout matrix as a markdown table."""
    cols = ("layout", "paper analog", "memory cost", "when auto picks it")
    rows = [(s.name, s.paper_analog, s.memory, s.when)
            for s in LAYOUTS.values()]
    widths = [max(len(c), *(len(r[i]) for r in rows))
              for i, c in enumerate(cols)]

    def line(vals):
        return "| " + " | ".join(v.ljust(w)
                                 for v, w in zip(vals, widths)) + " |"
    out = [line(cols), "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
    out += [line(r) for r in rows]
    return "\n".join(out)


# --------------------------------------------------------------------------
# Lowering
# --------------------------------------------------------------------------
def _check_structure(ensemble) -> None:
    """Model arrays arrive from outside the program (an `.npz`, a
    converter): check once what the kernels rely on per call."""
    t, d = ensemble.split_features.shape
    if ensemble.split_bins.shape != (t, d):
        raise ValueError(f"split_bins {tuple(ensemble.split_bins.shape)} "
                         f"does not match split_features {(t, d)}")
    if tuple(ensemble.leaf_values.shape[:2]) != (t, 1 << d):
        raise ValueError(f"leaf_values {tuple(ensemble.leaf_values.shape)} "
                         f"must be (T, 2^D, C) = ({t}, {1 << d}, C)")
    if t and d:
        sf = ensemble.split_features
        lo, hi = int(sf.min()), int(sf.max())
        if lo < 0 or hi >= ensemble.n_features:
            raise ValueError(f"split features span [{lo}, {hi}], outside "
                             f"the model's {ensemble.n_features} features")


def lower(ensemble, layout: str = "soa", *,
          tree_block: int = 0) -> LoweredEnsemble:
    """Lower a logical `ObliviousEnsemble` into one physical layout, on
    the ensemble's device.  `tree_block > 0` cuts the soa layout's staged
    tree blocks (soa only)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; known: "
                         f"{LAYOUT_NAMES}")
    if tree_block and layout != "soa":
        raise ValueError(f"tree_block is a soa-layout feature, got "
                         f"layout={layout!r}")
    _check_structure(ensemble)
    if layout == "soa":
        return _lower_soa(ensemble, tree_block)
    if layout == "depth_major":
        return _lower_depth_major(ensemble)
    return _lower_grouped(ensemble, bitpacked=layout == "bitpacked")


def _lower_soa(ensemble, tree_block: int) -> SoaLayout:
    blocks = None
    if tree_block and ensemble.n_trees > tree_block:
        blocks = []
        for start in range(0, ensemble.n_trees, tree_block):
            blk = ensemble.slice_trees(
                start, min(start + tree_block, ensemble.n_trees))
            blocks.append((blk.split_features.contiguous(),
                           blk.split_bins.contiguous(),
                           blk.leaf_values.contiguous()))
        blocks = tuple(blocks)
    return SoaLayout(ensemble.borders.contiguous(),
                     ensemble.split_features.contiguous(),
                     ensemble.split_bins.contiguous(),
                     ensemble.leaf_values.contiguous(), blocks,
                     n_outputs=ensemble.n_outputs)


def _lower_depth_major(ensemble) -> DepthMajorLayout:
    pow2 = (1 << np.arange(ensemble.depth, dtype=np.int64)).astype(
        np.float32)[:, None]
    return DepthMajorLayout(
        ensemble.borders.contiguous(),
        ensemble.split_features.t().contiguous(),
        ensemble.split_bins.t().contiguous(),
        torch.from_numpy(pow2).to(ensemble.device),
        ensemble.leaf_values.contiguous(), n_outputs=ensemble.n_outputs)


def _lower_grouped(ensemble, *, bitpacked: bool):
    """Bucket trees by true depth (depth-0 trees clamp to one always-left
    level, whose only reachable leaf is 0), each group sliced to its depth
    and its 2^d leaves.  Bitpacked groups transpose their splits to (d, Tg)
    planes and narrow the thresholds to uint8 where every one of the group
    fits a byte: a group holding PAD_SPLIT_BIN (a clamped depth-0 tree, or
    a pad level between real levels, which still counts toward the true
    depth) keeps int32."""
    device = ensemble.device
    depths = np.maximum(ensemble.true_depths, 1)
    sf = ensemble.split_features.cpu().numpy()
    sb = ensemble.split_bins.cpu().numpy()
    lv = ensemble.leaf_values.cpu().numpy()

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    groups = []
    for d in sorted(set(depths.tolist())):
        rows = np.flatnonzero(depths == d)
        gsf, gsb = sf[rows][:, :d], sb[rows][:, :d]
        glv = on_device(lv[rows][:, :1 << d])
        if not bitpacked:
            groups.append(DepthGroup(d, on_device(gsf), on_device(gsb), glv))
            continue
        narrow = gsb.size and 0 <= gsb.min() and gsb.max() <= 255
        groups.append(BitpackedGroup(
            d, on_device(gsf.T),
            on_device(gsb.T.astype(np.uint8 if narrow else np.int32)), glv))
    if not bitpacked:
        return DepthGroupedLayout(ensemble.borders.contiguous(),
                                  tuple(groups),
                                  n_outputs=ensemble.n_outputs)
    return BitpackedLayout(
        ensemble.borders.contiguous(), tuple(groups),
        n_outputs=ensemble.n_outputs,
        binary_split=bool((ensemble.n_borders <= 1).all()),
        n_features=ensemble.n_features)
