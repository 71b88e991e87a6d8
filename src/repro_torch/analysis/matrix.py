"""Capability-matrix enumeration and abstract tracing.

The port's counterpart of `src/repro/analysis/matrix.py`.  Cells are
enumerated from `registry.table()`, one per (op, impl, layout, bin dtype)
claim, so a new registration (or a new layout or dtype claim) is covered
by the contract checker with no new code here.

Each cell maps to one or more call variants: argument specs for the
registered function at the JAX package's canonical dims, following the
port's own call conventions (`kernels.ops`: soa ops take (T, D) splits,
the `_dm` / `_bp` ops the (D, T) planes, binarize its output dtype).
They are traced by `trace_tools.trace_abstract` under `FakeTensorMode`:
never executed, never compiled.  Cells of the `cuda` family run on fake
`cuda:0` tensors and add the shapes the card really runs, because a
launch plan's route and shared memory depend on the size: the bulk
shape, the serving buckets, the kNN head, the distance shapes, the
Covertype histogram by depth and the caps phase's rows past the opt-in
limit.  Layout-independent ops give identical calls on every layout, so
the trace cache collapses them; the checker's cells/traces counters show
the collapse.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.analysis import trace_tools
from repro_torch.analysis.trace_tools import Spec
from repro_torch.kernels import registry

# Canonical dims: the JAX package's.  Small on purpose: the lint rules are
# dtype and structure properties, and the card's shapes come as variants.
N, F, B, T, D, L, C = 64, 7, 9, 6, 4, 16, 2
FP = 128              # the JAX package's lane-aligned feature count
B_WIDE = 300          # >255 borders: forces the int32 bins path

# The shapes the card runs (chip_smoke.py): the Covertype model (1,000
# trees of depth 8, 7 classes, 54 features, 63 borders) on its test split
# and its serving buckets, the kNN head (a 1,000-tree depth-4 model on 533
# columns, 20 classes), the Covertype histogram (14 stats), and rows past
# the opt-in limit (the caps phase's widest features); and the split search
# of the benchmark's Covertype levels (128 borders, 129 bins, 7 outputs),
# a lanes plan (one output, 33 bins) and scans past 256 and 4,096 bins.
BULK_ROWS, BUCKET_ROWS, SMALL_ROWS = 139_440, 1024, 16
COV_F, COV_B, COV_T, COV_D, COV_C = 54, 63, 1000, 8, 7
KNN_ROWS, KNN_F, KNN_T, KNN_D, KNN_C = 2808, 533, 1000, 4, 20
HIST_ROWS, HIST_STATS, HIST_BINS = 325_360, 14, 64
KNN_STATS = 40
SPLIT_BINS = 129
WIDE_U8_F, WIDE_I32_F, WIDE_ROWS = 30_000, 7_500, 1024
KNN_QUERIES, KNN_REFS, KNN_K = 2841, 2808, 512
BULK_QUERIES, BULK_REFS = 4096, 22_464


@dataclasses.dataclass(frozen=True)
class Cell:
    """One capability claim: op x impl x layout x bin dtype."""
    op: str
    impl: str
    layout: str
    dtype: str

    @property
    def key(self) -> str:
        return f"{self.op}:{self.impl}"

    @property
    def family(self) -> str:
        return registry.get(self.op, self.impl).family

    def __str__(self) -> str:
        return f"{self.key}[{self.layout}/{self.dtype}]"


def enumerate_cells(*, ops_filter=None, impls_filter=None) -> list[Cell]:
    """Every capability-table cell, optionally filtered.  Filters take op
    names and "op:impl" keys respectively."""
    out = []
    for row in registry.table():
        if ops_filter is not None and row["op"] not in ops_filter:
            continue
        if impls_filter is not None \
                and f"{row['op']}:{row['impl']}" not in impls_filter:
            continue
        for lay in row["layouts"].split("/"):
            for dt in row["dtypes"].split("/"):
                out.append(Cell(row["op"], row["impl"], lay, dt))
    return out


@dataclasses.dataclass(frozen=True)
class Variant:
    """One call of a cell's function: `label` names the shape ("canonical",
    "bucket", ...); `call`, when set, drives the function itself (the
    rowwise batch route: one check and bind, a launch a query)."""
    label: str
    args: tuple
    kwargs: tuple[tuple[str, Any], ...] = ()
    call: Optional[Callable] = None


def _rowwise_batch(fn, queries, refs):
    """A run of rowwise queries against one reference set, as
    `KNNFeaturizer.transform(rowwise=True)` makes it."""
    from repro_torch.kernels import ops
    backend = "cuda" if queries.device.type == "cuda" else "torch_ref"
    run = ops.rowwise_batch(queries, refs, backend=backend)
    out = torch.empty((queries.shape[0], refs.shape[0]),
                      dtype=torch.float32, device=queries.device)
    for i in range(queries.shape[0]):
        fn(queries.select(0, i), refs, out=out.select(0, i), batch=run)
    return out


def _index_args(impl: str, rows: int, f: int, t: int, d: int,
                bt: torch.dtype, dev: str) -> tuple:
    i32 = torch.int32
    bins = Spec((rows, f), bt, dev)
    if impl.endswith("_dm"):
        return (bins, Spec((d, t), i32, dev), Spec((d, t), i32, dev),
                Spec((d, 1), torch.float32, dev))
    if impl.endswith("_bp"):
        plane = torch.uint8 if bt == torch.uint8 else i32
        return (bins, Spec((d, t), i32, dev), Spec((d, t), plane, dev))
    return bins, Spec((t, d), i32, dev), Spec((t, d), i32, dev)


def _fused_args(impl: str, rows: int, f: int, nb: int, t: int, d: int,
                c: int, dev: str) -> tuple:
    f32, i32 = torch.float32, torch.int32
    x, borders = Spec((rows, f), f32, dev), Spec((nb, f), f32, dev)
    lv = Spec((t, 1 << d, c), f32, dev)
    if impl.endswith("_dm"):
        return (x, borders, Spec((d, t), i32, dev), Spec((d, t), i32, dev),
                Spec((d, 1), f32, dev), lv)
    if impl.endswith("_bp"):
        plane = torch.uint8 if nb <= 255 else i32
        return (x, borders, Spec((d, t), i32, dev), Spec((d, t), plane, dev),
                lv)
    return x, borders, Spec((t, d), i32, dev), Spec((t, d), i32, dev), lv


def cell_variants(cell: Cell) -> list[Variant]:
    """The calls to trace for one cell: the canonical one, and on the
    `cuda` family the card's shapes."""
    f32, i32 = torch.float32, torch.int32
    card = cell.family == "cuda"
    dev = "cuda:0" if card else "cpu"
    bt = torch.uint8 if cell.dtype == "uint8" else i32
    wide = WIDE_U8_F if bt == torch.uint8 else WIDE_I32_F

    if cell.op == "binarize":
        kw = (("out_dtype", torch.uint8),) if cell.dtype == "uint8" else ()

        def v(label, rows, f, nb):
            return Variant(label, (Spec((rows, f), f32, dev),
                                   Spec((nb, f), f32, dev)), kw)
        out = [v("canonical", N, F, B)]
        if card:
            out += [v("bulk", BULK_ROWS, COV_F, COV_B),
                    v("bucket", BUCKET_ROWS, COV_F, COV_B),
                    v("bucket16", SMALL_ROWS, COV_F, COV_B),
                    v("knn", KNN_ROWS, KNN_F, COV_B),
                    v("past_optin", WIDE_ROWS, WIDE_U8_F, COV_B)]
        return out

    if cell.op == "l2sq":
        def v(label, q, n, k):
            query = Spec((q, k) if q else (k,), f32, dev)
            return Variant(label, (query, Spec((n, k), f32, dev)))
        out = [v("matrix", 8, 16, 5), v("rowwise", 0, 16, 5),
               Variant("batch", (Spec((3, 5), f32, dev),
                                 Spec((16, 5), f32, dev)),
                       call=_rowwise_batch)]
        if card:
            out += [v("knn_matrix", KNN_QUERIES, KNN_REFS, KNN_K),
                    v("bulk_matrix", BULK_QUERIES, BULK_REFS, KNN_K),
                    v("knn_rowwise", 0, KNN_REFS, KNN_K),
                    Variant("knn_batch", (Spec((3, KNN_K), f32, dev),
                                          Spec((KNN_REFS, KNN_K), f32, dev)),
                            call=_rowwise_batch)]
        return out

    if cell.op == "leaf_index":
        def v(label, rows, f, t, d):
            return Variant(label, _index_args(cell.impl, rows, f, t, d, bt,
                                              dev))
        out = [v("canonical", N, F, T, D)]
        if card:
            out += [v("bulk", BULK_ROWS, COV_F, COV_T, COV_D),
                    v("bucket", BUCKET_ROWS, COV_F, COV_T, COV_D),
                    v("bucket16", SMALL_ROWS, COV_F, COV_T, COV_D),
                    v("knn", KNN_ROWS, KNN_F, KNN_T, KNN_D),
                    v("past_optin", WIDE_ROWS, wide, 64, COV_D)]
        return out

    if cell.op == "leaf_gather":
        def v(label, rows, t, d, c):
            return Variant(label, (Spec((rows, t), i32, dev),
                                   Spec((t, 1 << d, c), f32, dev)))
        out = [v("canonical", N, T, D, C)]
        if card:
            out += [v("bulk", BULK_ROWS, COV_T, COV_D, COV_C),
                    v("bucket", BUCKET_ROWS, COV_T, COV_D, COV_C),
                    v("bucket16", SMALL_ROWS, COV_T, COV_D, COV_C),
                    v("knn", KNN_ROWS, KNN_T, KNN_D, KNN_C)]
        return out

    if cell.op == "histogram":
        def v(label, f, rows, stats, n_bins, n_leaves):
            return Variant(label, (Spec((f, rows), bt, dev),
                                   Spec((rows,), i32, dev),
                                   Spec((rows, stats), f32, dev)),
                           (("n_bins", n_bins), ("n_leaves", n_leaves)))
        out = [v("canonical", F, N, C, B + 1, 4)]
        if card:
            out += [v(f"covertype_d{d}", COV_F, HIST_ROWS, HIST_STATS,
                      HIST_BINS, 1 << d) for d in range(COV_D)]
            out += [v(f"knn_d{d}", KNN_F, KNN_ROWS, KNN_STATS, HIST_BINS,
                      1 << d) for d in range(KNN_D)]
            out += [v("stats66", F, 2048, 66, B + 1, 4)]
        return out

    if cell.op == "split_level":
        def v(label, f, rows, n_out, n_bins, d):
            return Variant(label, (Spec((f, (1 << d) * n_bins, 2 * n_out),
                                        f32, dev),
                                   Spec((f, n_bins), torch.bool, dev),
                                   Spec((f, rows), bt, dev),
                                   Spec((rows,), i32, dev)),
                           (("n_bins", n_bins), ("d", d), ("l2", 3.0)))
        out = [v("canonical", F, N, C, B + 1, 2)]
        if card:
            out += [v(f"covertype_d{d}", COV_F, HIST_ROWS, COV_C,
                      SPLIT_BINS, d) for d in range(COV_D)]
            out += [v("lanes", F, N, 1, 33, 4), v("bins257", F, N, C, 257, 3),
                    v("bins5000", 3, N, 2, 5000, 1)]
        return out

    assert cell.op == "fused_predict", cell.op
    # dtype claims the bins the kernel keeps on chip: uint8 needs <= 255
    # borders, int32 cells trace the > 255 path.
    nb = B if cell.dtype == "uint8" else B_WIDE
    cov_b = COV_B if cell.dtype == "uint8" else B_WIDE

    def v(label, rows, f, nb_, t, d, c):
        return Variant(label, _fused_args(cell.impl, rows, f, nb_, t, d, c,
                                          dev))
    out = [v("canonical", N, F, nb, T, D, C)]
    if card:
        out += [v("bulk", BULK_ROWS, COV_F, cov_b, COV_T, COV_D, COV_C),
                v("bucket", BUCKET_ROWS, COV_F, cov_b, COV_T, COV_D, COV_C),
                v("bucket16", SMALL_ROWS, COV_F, cov_b, COV_T, COV_D, COV_C),
                v("knn", KNN_ROWS, KNN_F, cov_b, KNN_T, KNN_D, KNN_C),
                v("past_optin", WIDE_ROWS, wide, cov_b, 64, COV_D, COV_C)]
    return out


# --------------------------------------------------------------------------
# Trace cache
# --------------------------------------------------------------------------
_TRACE_CACHE: dict[tuple, trace_tools.Trace] = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def trace_key(cell: Cell, variant: Variant) -> tuple:
    sig = tuple(a.short() if isinstance(a, Spec) else repr(a)
                for a in variant.args)
    return (cell.key, variant.label, sig, variant.kwargs)


def trace_variant(cell: Cell, variant: Variant) -> trace_tools.Trace:
    """The trace of one variant of the cell, through the cache."""
    key = trace_key(cell, variant)
    if key in _TRACE_CACHE:
        _CACHE_STATS["hits"] += 1
        return _TRACE_CACHE[key]
    fn = registry.get(cell.op, cell.impl).fn
    kwargs = dict(variant.kwargs)
    if variant.call is not None:
        traced = trace_tools.trace_abstract(
            lambda *a: variant.call(fn, *a, **kwargs), *variant.args)
    else:
        traced = trace_tools.trace_abstract(fn, *variant.args, **kwargs)
    _TRACE_CACHE[key] = traced
    _CACHE_STATS["misses"] += 1
    return traced


def trace_cell(cell: Cell) -> list[tuple[Variant, trace_tools.Trace]]:
    """(variant, trace) for every call variant of the cell.  Raises
    whatever the trace raises: the checker turns that into a capability
    finding."""
    return [(v, trace_variant(cell, v)) for v in cell_variants(cell)]


def cache_stats() -> dict[str, int]:
    return dict(_CACHE_STATS)


def reset_cache() -> None:
    _TRACE_CACHE.clear()
    _CACHE_STATS["hits"] = _CACHE_STATS["misses"] = 0


# --------------------------------------------------------------------------
# Canonical ensemble (plan lints and the layout-cost audit)
# --------------------------------------------------------------------------
def canonical_ensemble(*, n_features: int = FP, n_trees: int = 64,
                       n_borders: int = B, n_outputs: int = C,
                       depth: int = D, seed: int = 17):
    """The JAX package's canonical ensemble, array for array (the same
    seed and draws): mixed true depths at lowering-friendly dims, so the
    layout-cost audit compares model and lowered bytes without padding
    noise.  Returns (ensemble, true depths)."""
    from repro_torch.core import trees
    from repro_torch.core.trees import ObliviousEnsemble

    rng = np.random.default_rng(seed)
    borders = np.sort(rng.normal(size=(n_borders, n_features)), 0) \
        .astype(np.float32)
    sf = rng.integers(0, n_features, (n_trees, depth)).astype(np.int32)
    sb = rng.integers(1, n_borders + 1, (n_trees, depth)).astype(np.int32)
    lv = rng.normal(size=(n_trees, 1 << depth, n_outputs)) \
        .astype(np.float32)
    ens = ObliviousEnsemble(torch.from_numpy(sf), torch.from_numpy(sb),
                            torch.from_numpy(lv), torch.from_numpy(borders),
                            torch.full((n_features,), n_borders,
                                       dtype=torch.int32))
    true_depths = rng.integers(1, depth + 1, n_trees)
    true_depths[0] = depth          # keep dmax = depth
    return trees.truncate_tree_depths(ens, true_depths), true_depths
