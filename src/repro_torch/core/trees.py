"""Oblivious-tree ensemble: the CatBoost model structure over torch tensors.

The port's counterpart of `src/repro/core/trees.py`.  Structure of arrays:
  split_features (T, D) int32 — feature id tested at depth d of tree t
  split_bins     (T, D) int32 — border id; sample goes right iff bin >= split_bin
  leaf_values    (T, 2^D, C) float32
  borders        (B, F) float32 — per-feature bin borders (padded with +inf)
  n_borders      (F,)   int32   — true border count per feature
  base_score     (C,)   float32 — additive offset

All trees share one depth D; a shallower tree carries trailing levels with
split_bin = PAD_SPLIT_BIN, which always go left.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import PAD_SPLIT_BIN

_DTYPES = {"split_features": torch.int32, "split_bins": torch.int32,
           "leaf_values": torch.float32, "borders": torch.float32,
           "n_borders": torch.int32, "base_score": torch.float32}


@dataclasses.dataclass(frozen=True)
class ObliviousEnsemble:
    split_features: torch.Tensor    # (T, D) int32
    split_bins: torch.Tensor        # (T, D) int32
    leaf_values: torch.Tensor       # (T, 2^D, C) float32
    borders: torch.Tensor           # (B, F) float32
    n_borders: torch.Tensor         # (F,) int32
    base_score: Optional[torch.Tensor] = None   # (C,) float32

    def __post_init__(self):
        for name, dtype in _DTYPES.items():
            value = getattr(self, name)
            if value is not None:
                object.__setattr__(self, name, torch.as_tensor(value,
                                                               dtype=dtype))
        if self.base_score is None:
            object.__setattr__(self, "base_score", torch.zeros(
                (self.leaf_values.shape[2],), dtype=torch.float32,
                device=self.leaf_values.device))

    @property
    def n_trees(self) -> int:
        return self.split_features.shape[0]

    @property
    def depth(self) -> int:
        return self.split_features.shape[1]

    @property
    def n_outputs(self) -> int:
        return self.leaf_values.shape[2]

    @property
    def n_features(self) -> int:
        return self.borders.shape[1]

    @property
    def device(self) -> torch.device:
        return self.leaf_values.device

    @property
    def true_depths(self) -> np.ndarray:
        """(T,) int32: each tree's depth with its trailing always-left
        (PAD_SPLIT_BIN) levels stripped."""
        sb = self.split_bins.cpu().numpy()
        if sb.shape[0] == 0:
            return np.zeros((0,), np.int32)
        trailing_pad = np.cumprod(
            (sb == PAD_SPLIT_BIN)[:, ::-1], axis=1).sum(axis=1)
        return (sb.shape[1] - trailing_pad).astype(np.int32)

    def lower(self, layout: str = "soa", **lower_kw):
        """Lower the logical model into a physical `LoweredEnsemble`
        layout (see `repro_torch.core.layout`) on its own device."""
        from repro_torch.core import layout as layout_mod
        return layout_mod.lower(self, layout, **lower_kw)

    def to(self, device: torch.device | str) -> "ObliviousEnsemble":
        """The same ensemble with every array on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})

    def slice_trees(self, start: int, stop: int) -> "ObliviousEnsemble":
        """Tree-block view (the paper's CalcTreesBlockedImpl granularity)."""
        if not 0 <= start <= stop <= self.n_trees:
            raise ValueError(
                f"slice_trees({start}, {stop}) out of range for an "
                f"ensemble of {self.n_trees} trees "
                "(need 0 <= start <= stop <= n_trees)")
        return dataclasses.replace(
            self,
            split_features=self.split_features[start:stop],
            split_bins=self.split_bins[start:stop],
            leaf_values=self.leaf_values[start:stop],
        )

    def save(self, path: str | pathlib.Path) -> None:
        """Write the `.npz` the JAX package's `ObliviousEnsemble.save`
        writes: the same keys, dtypes and shapes."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **{f.name: getattr(self, f.name).cpu().numpy()
                          for f in dataclasses.fields(self)})

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "ObliviousEnsemble":
        """Read an `.npz` written by either package (on the CPU)."""
        with np.load(path) as z:
            return cls(**{k: torch.from_numpy(z[k]) for k in z.files})

    def describe(self) -> dict[str, Any]:
        return dict(n_trees=self.n_trees, depth=self.depth,
                    n_outputs=self.n_outputs, n_features=self.n_features,
                    n_leaf_params=int(np.prod(self.leaf_values.shape)))

    def describe_json(self) -> str:
        return json.dumps(self.describe())


def empty_ensemble(n_features: int, depth: int, n_outputs: int,
                   borders: torch.Tensor, n_borders: torch.Tensor
                   ) -> ObliviousEnsemble:
    """A tree-less ensemble over `borders`, on their device: the start of
    an ensemble grown tree by tree (`n_features` is the borders' width,
    kept for the JAX package's signature)."""
    device = torch.as_tensor(borders).device
    return ObliviousEnsemble(
        split_features=torch.zeros((0, depth), dtype=torch.int32,
                                   device=device),
        split_bins=torch.zeros((0, depth), dtype=torch.int32, device=device),
        leaf_values=torch.zeros((0, 2 ** depth, n_outputs),
                                dtype=torch.float32, device=device),
        borders=borders,
        n_borders=n_borders,
    )


def truncate_tree_depths(ensemble: ObliviousEnsemble,
                         depths) -> ObliviousEnsemble:
    """Truncate tree t to `depths[t]` levels via trailing always-left
    pads — the CatBoost shallow-tree convention (`split_bins` =
    `PAD_SPLIT_BIN` beyond the true depth, unreachable leaf values
    zeroed).  `depths[t]` may be 0 (a constant tree) up to
    `ensemble.depth` (unchanged)."""
    depths = np.asarray(depths, np.int64)
    if depths.shape != (ensemble.n_trees,):
        raise ValueError(f"need one depth per tree: got shape "
                         f"{depths.shape} for {ensemble.n_trees} trees")
    if depths.size and not (0 <= depths.min()
                            and depths.max() <= ensemble.depth):
        raise ValueError(f"depths must lie in [0, {ensemble.depth}], "
                         f"got [{depths.min()}, {depths.max()}]")
    sb = ensemble.split_bins.cpu().numpy().copy()
    lv = ensemble.leaf_values.cpu().numpy().copy()
    for t, d in enumerate(depths):
        sb[t, d:] = PAD_SPLIT_BIN
        lv[t, 1 << d:] = 0.0
    device = ensemble.device
    return dataclasses.replace(
        ensemble, split_bins=torch.from_numpy(sb).to(device),
        leaf_values=torch.from_numpy(lv).to(device))


def concat_ensembles(a: ObliviousEnsemble, b: ObliviousEnsemble
                     ) -> ObliviousEnsemble:
    """Append b's trees to a (a's borders and base score win).

    Two ensembles are only summable when they agree on tree depth,
    output width and the quantization borders: a mismatch silently
    produces garbage leaf sums, so each is a hard error here."""
    if a.depth != b.depth:
        raise ValueError(f"cannot concat ensembles of different depth: "
                         f"{a.depth} vs {b.depth}")
    if a.n_outputs != b.n_outputs:
        raise ValueError(f"cannot concat ensembles with different "
                         f"n_outputs: {a.n_outputs} vs {b.n_outputs}")
    if a.borders.shape != b.borders.shape:
        raise ValueError(f"cannot concat ensembles quantized with "
                         f"different border tables: "
                         f"{tuple(a.borders.shape)} vs "
                         f"{tuple(b.borders.shape)}")
    if not torch.equal(a.borders.cpu(), b.borders.cpu()):
        raise ValueError(
            "cannot concat ensembles quantized with different border "
            "values: split_bins index into incompatible bin spaces")
    dev = a.device
    return dataclasses.replace(
        a,
        split_features=torch.cat([a.split_features,
                                  b.split_features.to(dev)]),
        split_bins=torch.cat([a.split_bins, b.split_bins.to(dev)]),
        leaf_values=torch.cat([a.leaf_values, b.leaf_values.to(dev)]),
    )
