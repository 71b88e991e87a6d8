"""Synthetic Covertype and image-embeddings workloads (the paper's Table 1
rows), made with numpy.

The port's copy of `Dataset`, `_class_mixture`, `covertype` and
`image_embeddings` from `src/repro/data/synthetic.py`: the same seed gives
bit-identical arrays.

| name              | rows x cols      | classes | loss       | depth | lr   |
|-------------------|------------------|---------|------------|-------|------|
| covertype         | 464800 x 54      | 7       | MultiClass | 8     | 0.50 |
| image_embeddings  | 5649 x 512 (emb) | 20      | MultiClass | 4     | 0.05 |
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.boosting import BoostingParams


@dataclasses.dataclass
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    loss: str
    n_classes: int = 0
    params: BoostingParams = dataclasses.field(
        default_factory=BoostingParams)
    emb_train: Optional[np.ndarray] = None           # embeddings only
    emb_test: Optional[np.ndarray] = None

    @property
    def shape(self):
        return self.x_train.shape, self.x_test.shape


def _class_mixture(rng, n, f, c, *, informative=0.4, noise=1.0,
                   integer_frac=0.0):
    """Gaussian class mixture with optional integer-valued features."""
    n_inf = max(2, int(f * informative))
    centers = rng.normal(scale=2.0, size=(c, n_inf))
    y = rng.integers(0, c, size=n)
    x = rng.normal(scale=noise, size=(n, f)).astype(np.float32)
    x[:, :n_inf] += centers[y]
    if integer_frac > 0:
        n_int = int(f * integer_frac)
        x[:, -n_int:] = np.round(x[:, -n_int:] * 3)
    return x.astype(np.float32), y.astype(np.int32)


def covertype(scale: float = 1.0, seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    n = int(464800 * scale)
    x, y = _class_mixture(rng, n, 54, 7, informative=0.5, integer_frac=0.4)
    cut = int(n * 0.7)                    # paper: 70:30 split
    return Dataset("covertype", x[:cut], y[:cut], x[cut:], y[cut:],
                   loss="multiclass", n_classes=7,
                   params=BoostingParams(depth=8, learning_rate=0.5))


def image_embeddings(scale: float = 1.0, seed: int = 4) -> Dataset:
    """resnet34-style 512-dim embeddings, 20 classes (PASCAL VOC subset).
    The tabular features are the embeddings themselves; the kNN featurizer
    appends its features at fit time (`core.knn.augment_with_knn`)."""
    rng = np.random.default_rng(seed)
    n_tr, n_te = int(2808 * scale), int(2841 * scale)
    c, k = 20, 512
    centers = rng.normal(scale=1.2, size=(c, k)).astype(np.float32)

    def make(n):
        y = rng.integers(0, c, size=n).astype(np.int32)
        e = centers[y] + rng.normal(scale=1.0, size=(n, k)).astype(np.float32)
        e = np.maximum(e, 0.0)          # post-ReLU embeddings are nonneg
        return e, y

    e_tr, y_tr = make(n_tr)
    e_te, y_te = make(n_te)
    return Dataset("image_embeddings", e_tr, y_tr, e_te, y_te,
                   loss="multiclass", n_classes=20,
                   params=BoostingParams(depth=4, learning_rate=0.05),
                   emb_train=e_tr, emb_test=e_te)
