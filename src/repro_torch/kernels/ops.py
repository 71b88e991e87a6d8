"""Public kernel ops: registry-dispatched wrappers around the port's
CUDA kernels and their plain PyTorch versions.

The port's counterpart of `src/repro/kernels/ops.py`.  Each op has a
`torch_ref` implementation (the plain versions in `kernels.ref`, and the
split search's beside its wrapper) and a `cuda` one (the kernel wrappers
in `kernels.binarize`, `leaf_index`, `leaf_gather`, `fused_predict`,
`histogram`, `split_level` and `l2dist`); binarize takes its output dtype
as an argument (int32, or uint8 for the one-byte quantized-pool stream).
`l2sq` dispatches on the query's rank: rowwise for a (K,) query, the
matrix form for (M, K) queries.
`backend="auto"` resolves from the device of the data (`registry.resolve`).

`leaf_index` and `fused_predict` have siblings for the depth_major
(`torch_ref_dm` / `cuda_dm`) and bitpacked (`torch_ref_bp` / `cuda_bp`)
layouts, which take (D, T) split planes; the `_dm` / `_bp` ops route to
them through `registry.resolve(..., layout=)`.

The kernels mask their own ragged edges, so neither the data nor the model
is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import binarize as _binarize_k
from repro_torch.kernels import fused_predict as _fused_k
from repro_torch.kernels import histogram as _hist_k
from repro_torch.kernels import l2dist as _l2_k
from repro_torch.kernels import leaf_gather as _gather_k
from repro_torch.kernels import leaf_index as _index_k
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import registry
from repro_torch.kernels import split_level as _split_k
from repro_torch.kernels.ref import MAX_U8_BORDERS  # noqa: F401

Backend = str

# Sentinel split bin guaranteeing `bins < PAD_SPLIT_BIN`: padded trees and
# truncated levels always go left.  Canonical definition; `core.trees`
# re-exports it.
PAD_SPLIT_BIN = 1 << 30

# The wrappers that launch a kernel, each with its `launches` count.
KERNELS = {
    "binarize": _binarize_k.binarize,
    "leaf_index": _index_k.leaf_index,
    "leaf_gather": _gather_k.leaf_gather,
    "fused_predict": _fused_k.fused_predict,
    "leaf_index_dm": _index_k.leaf_index_dm,
    "fused_predict_dm": _fused_k.fused_predict_dm,
    "leaf_index_bp": _index_k.leaf_index_bp,
    "fused_predict_bp": _fused_k.fused_predict_bp,
    "histogram": _hist_k.histogram,
    "split_level": _split_k.split_level,
    "l2sq_rowwise": _l2_k.l2sq_rowwise,
    "l2sq_matrix": _l2_k.l2sq_matrix,
}

# The layouts each op's soa-array implementations take: depth_grouped
# holds soa arrays group by group (its fused route binarizes once and
# indexes each group instead); binarize and leaf_gather read no model
# structure.
ALL_LAYOUTS = ("soa", "depth_major", "depth_grouped", "bitpacked")
SOA_LAYOUTS = ("soa", "depth_grouped")


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last `reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def pad_dim(a: torch.Tensor, axis: int, target: int, value=0) -> torch.Tensor:
    """Pad `a` along `axis` up to `target` with `value` (no copy when it
    is already that long)."""
    pad = target - a.shape[axis]
    if pad == 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    fill = torch.full(shape, value, dtype=a.dtype, device=a.device)
    return torch.cat([a, fill], dim=axis)


def _bins_dtype(bins: torch.Tensor) -> str:
    return "uint8" if bins.dtype == torch.uint8 else "int32"


# --------------------------------------------------------------------------
# Registered implementations
# --------------------------------------------------------------------------
@registry.register("binarize", "torch_ref", dtypes=("int32", "uint8"),
                   layouts=ALL_LAYOUTS,
                   constraints="any shape; uint8 bins need <= 255 borders")
def _binarize_ref(x, borders, out_dtype=torch.int32):
    if out_dtype == torch.uint8:
        return _ref.binarize_u8(x, borders)
    return _ref.binarize(x, borders)


@registry.register("binarize", "cuda", dtypes=("int32", "uint8"),
                   layouts=ALL_LAYOUTS,
                   constraints="uint8 bins need <= 255 borders; "
                               "csrc/binarize.cu")
def _binarize_cuda(x, borders, out_dtype=torch.int32):
    return _binarize_k.binarize(x, borders, out_dtype=out_dtype)


# Declared widening exception, the JAX package's `ref` one: the plain
# version widens each gathered uint8 column to int32 for its compare, so
# the 2^30 PAD_SPLIT_BIN of padded trees never goes right.  The kernels
# compare the bytes as they are (`cuda`, `cuda_bp`; `torch_ref_bp`
# against a uint8 plane) and carry no suppression.
@registry.register("leaf_index", "torch_ref", dtypes=("int32", "uint8"),
                   layouts=SOA_LAYOUTS,
                   constraints="any shape; compares in int32",
                   suppressions=(
                       "widening: the plain version compares the gathered "
                       "uint8 column in int32 against int32 split bins "
                       "(PAD_SPLIT_BIN never goes right); it runs on the "
                       "CPU, where no shared-memory contract applies "
                       "(depth_grouped routes here too)",))
def _leaf_index_ref(bins, sf, sb):
    return _ref.leaf_index(bins, sf, sb)


@registry.register("leaf_index", "cuda", dtypes=("int32", "uint8"),
                   layouts=SOA_LAYOUTS,
                   constraints="depth <= 16; csrc/leaf_index.cu")
def _leaf_index_cuda(bins, sf, sb):
    return _index_k.leaf_index(bins, sf, sb)


@registry.register("leaf_gather", "torch_ref", layouts=ALL_LAYOUTS,
                   constraints="any shape")
def _leaf_gather_ref(idx, lv):
    return _ref.leaf_gather(idx, lv)


@registry.register("leaf_gather", "cuda", layouts=ALL_LAYOUTS,
                   constraints="any outputs (slabs of <= 32); "
                               "csrc/leaf_gather.cu")
def _leaf_gather_cuda(idx, lv):
    return _gather_k.leaf_gather(idx, lv)


@registry.register("fused_predict", "torch_ref", layouts=SOA_LAYOUTS,
                   constraints="any shape")
def _fused_ref(x, borders, sf, sb, lv):
    return _ref.fused_predict(x, borders, sf, sb, lv)


@registry.register("fused_predict", "cuda", dtypes=("int32", "uint8"),
                   layouts=SOA_LAYOUTS,
                   constraints="depth <= 16; uint8 bins "
                               "tile when <= 255 borders; "
                               "csrc/fused_predict.cu")
def _fused_cuda(x, borders, sf, sb, lv):
    return _fused_k.fused_predict(x, borders, sf, sb, lv)


# Depth-major siblings: (D, T) int32 planes and (D, 1) f32 level weights.
# Declared widening exception, the port's own: its depth-major plain
# version compares as `torch_ref` does (the JAX package's `ref_dm` gathers
# through a one-hot matmul instead, which its checker sanctions).
@registry.register("leaf_index", "torch_ref_dm", dtypes=("int32", "uint8"),
                   layouts=("depth_major",),
                   constraints="(D, T) planes; any shape",
                   suppressions=(
                       "widening: the plain version compares the gathered "
                       "uint8 column in int32 against the int32 plane, as "
                       "torch_ref does; it runs on the CPU, where no "
                       "shared-memory contract applies",))
def _leaf_index_ref_dm(bins, sf_dm, sb_dm, pow2):
    return _ref.leaf_index_depth_major(bins, sf_dm, sb_dm, pow2)


@registry.register("leaf_index", "cuda_dm", dtypes=("int32", "uint8"),
                   layouts=("depth_major",),
                   constraints="depth <= 16; csrc/leaf_index_dm.cu")
def _leaf_index_cuda_dm(bins, sf_dm, sb_dm, pow2):
    return _index_k.leaf_index_dm(bins, sf_dm, sb_dm, pow2)


@registry.register("fused_predict", "torch_ref_dm", layouts=("depth_major",),
                   constraints="(D, T) planes; any shape")
def _fused_ref_dm(x, borders, sf_dm, sb_dm, pow2, lv):
    return _ref.fused_predict_depth_major(x, borders, sf_dm, sb_dm, pow2, lv)


@registry.register("fused_predict", "cuda_dm", dtypes=("int32", "uint8"),
                   layouts=("depth_major",),
                   constraints="depth <= 16; "
                               "csrc/fused_predict_dm.cu")
def _fused_cuda_dm(x, borders, sf_dm, sb_dm, pow2, lv):
    return _fused_k.fused_predict_dm(x, borders, sf_dm, sb_dm, pow2, lv)


# Bitpacked siblings: (D, T) planes, thresholds uint8 or int32.
@registry.register("leaf_index", "torch_ref_bp", dtypes=("int32", "uint8"),
                   layouts=("bitpacked",),
                   constraints="(D, T) planes; any shape; integer only")
def _leaf_index_ref_bp(bins, sf_bp, sb_bp):
    return _ref.leaf_index_bitpacked(bins, sf_bp, sb_bp)


@registry.register("leaf_index", "cuda_bp", dtypes=("int32", "uint8"),
                   layouts=("bitpacked",),
                   constraints="depth <= 16; 32-row ballot words; "
                               "csrc/leaf_index_bp.cu")
def _leaf_index_cuda_bp(bins, sf_bp, sb_bp):
    return _index_k.leaf_index_bp(bins, sf_bp, sb_bp)


@registry.register("fused_predict", "torch_ref_bp", layouts=("bitpacked",),
                   constraints="(D, T) planes; any shape")
def _fused_ref_bp(x, borders, sf_bp, sb_bp, lv):
    return _ref.fused_predict_bitpacked(x, borders, sf_bp, sb_bp, lv)


@registry.register("fused_predict", "cuda_bp", dtypes=("int32", "uint8"),
                   layouts=("bitpacked",),
                   constraints="depth <= 16; "
                               "csrc/fused_predict_bp.cu")
def _fused_cuda_bp(x, borders, sf_bp, sb_bp, lv):
    return _fused_k.fused_predict_bp(x, borders, sf_bp, sb_bp, lv)


# The training histogram reads no model structure: every layout.  Bins
# are uint8 (a pool) or int32 (`fit_bins`).  Declared widening exception,
# the JAX package's `ref` one: the plain version's segment ids are
# `leaf * n_bins + bins` in int64 for `index_add_` (the shape of the
# widening bug the checker exists to catch, here on purpose: clarity over
# bandwidth); the kernel reads the bytes.
@registry.register("histogram", "torch_ref", dtypes=("int32", "uint8"),
                   layouts=ALL_LAYOUTS,
                   constraints="any shape; segment-sum by index_add_",
                   suppressions=(
                       "widening: the plain segment sum forms int64 "
                       "segment ids from pool bins for index_add_; the "
                       "CUDA kernel reads the uint8 stream as it is",))
def _histogram_ref(bins_t, leaf, g, *, n_bins, n_leaves):
    return _ref.histogram(bins_t, leaf, g, n_bins=n_bins, n_leaves=n_leaves)


@registry.register("histogram", "cuda", dtypes=("int32", "uint8"),
                   layouts=ALL_LAYOUTS,
                   constraints="finite; a launch per 64 stats; int64 fixed "
                               "point, the same bits every launch; "
                               "csrc/histogram.cu")
def _histogram_cuda(bins_t, leaf, g, *, n_bins, n_leaves):
    return _hist_k.histogram(bins_t, leaf, g, n_bins=n_bins,
                             n_leaves=n_leaves)


# The split search of a level reads no model structure: every layout.
# Declared widening exception, as the plain histogram's: the plain
# version compares the chosen feature's column widened to int32 (one
# column of the pool, clarity over bandwidth); the kernel reads the bytes.
@registry.register("split_level", "torch_ref", dtypes=("int32", "uint8"),
                   layouts=ALL_LAYOUTS,
                   constraints="any shape; sums in core.split_sums' order",
                   suppressions=(
                       "widening: the plain version widens the chosen "
                       "feature's uint8 column to int32 to compare it with "
                       "b*; the CUDA kernel reads the uint8 stream as it "
                       "is",))
def _split_level_ref(hist, valid, bins_t, leaf, *, n_bins, d, l2):
    return _split_k.split_level_plain(hist, valid, bins_t, leaf,
                                      n_bins=n_bins, d=d, l2=l2)


@registry.register("split_level", "cuda", dtypes=("int32", "uint8"),
                   layouts=ALL_LAYOUTS,
                   constraints="three launches a level, no host sync; the "
                               "plain version's bits; csrc/split_level.cu")
def _split_level_cuda(hist, valid, bins_t, leaf, *, n_bins, d, l2):
    return _split_k.split_level(hist, valid, bins_t, leaf, n_bins=n_bins,
                                d=d, l2=l2)


# The kNN distances read no model structure: every layout.  The op
# dispatches on the query's rank, as the JAX package's `l2sq` does; the
# rowwise form takes `out=` and `batch=` (`l2dist.l2sq_rowwise`).
@registry.register("l2sq", "torch_ref", dtypes=("float32",),
                   layouts=ALL_LAYOUTS,
                   constraints="rowwise (K,)x(N,K) or matrix (M,K)x(N,K)")
def _l2sq_ref(a, b, *, out=None, batch=None):
    if a.ndim != 1:
        _matrix_takes_no_out(out, batch)
        return _ref.l2sq_matrix(a, b)
    # on CPU tensors the wrapper is the plain version (written into `out`)
    return _l2_k.l2sq_rowwise(a, b, out=out, batch=batch)


@registry.register("l2sq", "cuda", dtypes=("float32",), layouts=ALL_LAYOUTS,
                   constraints="rowwise (K,)x(N,K), q in registers, any K: "
                               "csrc/l2sq_rowwise.cu; matrix (M,K)x(N,K), "
                               "3xTF32 wgmma fed by TMA: "
                               "csrc/l2sq_matrix.cu")
def _l2sq_cuda(a, b, *, out=None, batch=None):
    if a.ndim == 1:
        return _l2_k.l2sq_rowwise(a, b, out=out, batch=batch)
    _matrix_takes_no_out(out, batch)
    return _l2_k.l2sq_matrix(a, b)


def _matrix_takes_no_out(out, batch):
    if out is not None or batch is not None:
        raise ValueError("l2sq: out= and batch= belong to the rowwise form "
                         "(a (K,) query)")


# --------------------------------------------------------------------------
# Public ops
# --------------------------------------------------------------------------
def binarize(x: torch.Tensor, borders: torch.Tensor, *,
             backend: Backend = "auto") -> torch.Tensor:
    """(N, F) f32, (B, F) f32 -> (N, F) int32 bin indices."""
    return registry.dispatch("binarize", backend, x, borders)


def binarize_u8(x: torch.Tensor, borders: torch.Tensor, *,
                backend: Backend = "auto") -> torch.Tensor:
    """(N, F) f32, (B, F) f32 -> (N, F) uint8 bin indices (B <= 255): the
    quantized-pool stream the paper's CalcIndexes loop consumes."""
    return registry.dispatch("binarize", backend, x, borders, dtype="uint8",
                             out_dtype=torch.uint8)


def leaf_index(bins: torch.Tensor, split_features: torch.Tensor,
               split_bins: torch.Tensor, *,
               backend: Backend = "auto") -> torch.Tensor:
    """(N, F) i32|u8, (T, D) i32, (T, D) i32 -> (N, T) int32 leaf ids."""
    return registry.dispatch("leaf_index", backend, bins, split_features,
                             split_bins, dtype=_bins_dtype(bins))


def leaf_gather(idx: torch.Tensor, leaf_values: torch.Tensor, *,
                backend: Backend = "auto") -> torch.Tensor:
    """(N, T) i32, (T, L, C) f32 -> (N, C) f32 summed leaf values."""
    return registry.dispatch("leaf_gather", backend, idx, leaf_values)


def fused_predict(x: torch.Tensor, borders: torch.Tensor,
                  split_features: torch.Tensor, split_bins: torch.Tensor,
                  leaf_values: torch.Tensor, *,
                  backend: Backend = "auto") -> torch.Tensor:
    """Fused binarize + index + gather -> (N, C) f32."""
    return registry.dispatch("fused_predict", backend, x, borders,
                             split_features, split_bins, leaf_values)


def leaf_index_dm(bins: torch.Tensor, split_features_dm: torch.Tensor,
                  split_bins_dm: torch.Tensor, pow2: torch.Tensor, *,
                  backend: Backend = "auto") -> torch.Tensor:
    """(N, F) i32|u8, (D, T) i32 planes, (D, 1) f32 weights -> (N, T)
    int32 leaf ids (depth_major layout)."""
    return registry.dispatch("leaf_index", backend, bins, split_features_dm,
                             split_bins_dm, pow2, dtype=_bins_dtype(bins),
                             layout="depth_major")


def fused_predict_dm(x: torch.Tensor, borders: torch.Tensor,
                     split_features_dm: torch.Tensor,
                     split_bins_dm: torch.Tensor, pow2: torch.Tensor,
                     leaf_values: torch.Tensor, *,
                     backend: Backend = "auto") -> torch.Tensor:
    """Fused predict on the depth_major layout -> (N, C) f32."""
    return registry.dispatch("fused_predict", backend, x, borders,
                             split_features_dm, split_bins_dm, pow2,
                             leaf_values, layout="depth_major")


def leaf_index_bp(bins: torch.Tensor, split_features_bp: torch.Tensor,
                  split_bins_bp: torch.Tensor, *,
                  backend: Backend = "auto") -> torch.Tensor:
    """(N, F) i32|u8, (D, T) i32 features, (D, T) u8|i32 thresholds ->
    (N, T) int32 leaf ids (bitpacked layout)."""
    return registry.dispatch("leaf_index", backend, bins, split_features_bp,
                             split_bins_bp, dtype=_bins_dtype(bins),
                             layout="bitpacked")


def fused_predict_bp(x: torch.Tensor, borders: torch.Tensor,
                     split_features_bp: torch.Tensor,
                     split_bins_bp: torch.Tensor, leaf_values: torch.Tensor,
                     *, backend: Backend = "auto") -> torch.Tensor:
    """Fused predict on one bitpacked depth group -> (N, C) f32."""
    return registry.dispatch("fused_predict", backend, x, borders,
                             split_features_bp, split_bins_bp, leaf_values,
                             layout="bitpacked")


def histogram(bins_t: torch.Tensor, leaf: torch.Tensor, g: torch.Tensor, *,
              n_bins: int, n_leaves: int,
              backend: Backend = "auto") -> torch.Tensor:
    """(F, N) i32|u8 feature-major bins, (N,) i32 leaf ids, (N, S) f32
    per-sample stats -> (F, n_leaves * n_bins, S) f32 histogram.

    The training hot loop (one call per tree level): stats accumulate per
    (feature, leaf, bin) cell.  `g` usually holds gradients and hessians
    side by side, so both histograms cost one pass."""
    return registry.dispatch("histogram", backend, bins_t, leaf, g,
                             dtype=_bins_dtype(bins_t), n_bins=n_bins,
                             n_leaves=n_leaves)


def l2sq_rowwise(q: torch.Tensor, refs: torch.Tensor, *,
                 backend: Backend = "auto", out: torch.Tensor | None = None,
                 batch: _l2_k.RowwiseBatch | None = None) -> torch.Tensor:
    """(K,), (N, K) -> (N,) squared L2 distances, written into `out` when
    given; `batch` (from `rowwise_batch`) carries the checks of a run of
    queries against these refs (`l2dist.l2sq_rowwise`)."""
    return registry.dispatch("l2sq", backend, q, refs, dtype="float32",
                             out=out, batch=batch)


def rowwise_batch(queries: torch.Tensor, refs: torch.Tensor, *,
                  backend: Backend = "auto") -> _l2_k.RowwiseBatch:
    """Check queries (Q, K) and refs (N, K) once for a run of
    `l2sq_rowwise(queries[i], refs, out=..., batch=...)` calls on
    `backend` (refused where that backend is, as `dispatch` would; not
    counted as a dispatch)."""
    registry.resolve("l2sq", backend, device=queries.device,
                     dtype="float32")
    return _l2_k.rowwise_batch(queries, refs)


def l2sq_matrix(a: torch.Tensor, b: torch.Tensor, *,
                backend: Backend = "auto") -> torch.Tensor:
    """(M, K), (N, K) -> (M, N) squared L2 distance matrix."""
    return registry.dispatch("l2sq", backend, a, b, dtype="float32")


# The plan's entries keep the JAX package's `_prepadded` names, so each
# call site in `core.predictor` and `core.layout` maps to its counterpart
# there.  The CUDA kernels mask their own edges, so a lowered model is
# never padded and these are the public ops themselves.
binarize_prepadded = binarize
binarize_u8_prepadded = binarize_u8
leaf_index_prepadded = leaf_index
leaf_gather_prepadded = leaf_gather
fused_predict_prepadded = fused_predict
leaf_index_dm_prepadded = leaf_index_dm
fused_predict_dm_prepadded = fused_predict_dm
leaf_index_bp_prepadded = leaf_index_bp
fused_predict_bp_prepadded = fused_predict_bp
