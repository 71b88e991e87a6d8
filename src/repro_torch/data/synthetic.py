"""Synthetic datasets of the paper's five workloads (Table 1), made with
numpy.

The port's copy of `src/repro/data/synthetic.py`: the same name, scale and
seed give bit-identical arrays.  `load(name, scale, seed)` picks one from
`REGISTRY`; `scale` shrinks the row counts and keeps the widths.

| name              | rows x cols      | classes | loss       | depth | lr   |
|-------------------|------------------|---------|------------|-------|------|
| mq2008            | 9630 x 46        | (rank)  | YetiRank   | 6     | 0.02 |
| santander         | 400000 x 200     | 2       | LogLoss    | 1     | 0.01 |
| covertype         | 464800 x 54      | 7       | MultiClass | 8     | 0.50 |
| year_prediction   | 515345 x 90      | (reg)   | MAE        | 6     | 0.30 |
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
    group_index_train: Optional[np.ndarray] = None   # ranking only, (G, S)
    group_index_test: Optional[np.ndarray] = None
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


def santander(scale: float = 1.0, seed: int = 1) -> Dataset:
    rng = np.random.default_rng(seed)
    n = int(400000 * scale)
    x, y = _class_mixture(rng, 2 * n, 200, 2, informative=0.2, noise=2.0)
    # non-normalized: scale features wildly, like the real Santander data
    x *= rng.lognormal(1.0, 1.0, size=(1, 200)).astype(np.float32)
    return Dataset("santander", x[:n], y[:n], x[n:], y[n:],
                   loss="logloss", n_classes=2,
                   params=BoostingParams(depth=1, learning_rate=0.01))


def year_prediction_msd(scale: float = 1.0, seed: int = 2) -> Dataset:
    rng = np.random.default_rng(seed)
    n_tr, n_te = int(463715 * scale), int(51630 * scale)
    n = n_tr + n_te
    f = 90
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=(f,)).astype(np.float32) * (rng.random(f) < 0.3)
    year = 1965.0 + 15.0 * np.tanh(x @ w / 3.0) + 20.0 * rng.random(n) + \
        5.0 * np.sin(x[:, 0] * 2)
    y = np.clip(year, 1922, 2011).astype(np.float32)
    x *= rng.lognormal(0.5, 0.8, size=(1, f)).astype(np.float32)
    return Dataset("year_prediction_msd", x[:n_tr], y[:n_tr],
                   x[n_tr:], y[n_tr:], loss="mae",
                   params=BoostingParams(depth=6, learning_rate=0.3))


def _group_index(rng, n_docs, avg_group):
    """Pack n_docs into groups; return (G, S) -1-padded index matrix."""
    sizes = []
    left = n_docs
    while left > 0:
        s = int(np.clip(rng.poisson(avg_group), 2, 120))
        s = min(s, left)
        sizes.append(s)
        left -= s
    width = max(sizes)
    gi = np.full((len(sizes), width), -1, np.int32)
    pos = 0
    for g, s in enumerate(sizes):
        gi[g, :s] = np.arange(pos, pos + s)
        pos += s
    return gi


def mq2008(scale: float = 1.0, seed: int = 3) -> Dataset:
    rng = np.random.default_rng(seed)
    n_tr, n_te = int(9630 * scale), int(2874 * scale)
    f = 46
    w = rng.normal(size=(f,)).astype(np.float32)

    def make(n):
        x = rng.random(size=(n, f)).astype(np.float32)
        score = x @ w + 0.5 * rng.normal(size=n)
        rel = np.digitize(score, np.quantile(score, [0.6, 0.85])).astype(
            np.float32)          # relevance 0/1/2 like LETOR
        return x, rel

    x_tr, y_tr = make(n_tr)
    x_te, y_te = make(n_te)
    return Dataset("mq2008", x_tr, y_tr, x_te, y_te, loss="yetirank",
                   params=BoostingParams(depth=6, learning_rate=0.02),
                   group_index_train=_group_index(rng, n_tr, 12),
                   group_index_test=_group_index(rng, n_te, 12))


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


REGISTRY = {
    "covertype": covertype,
    "santander": santander,
    "year_prediction_msd": year_prediction_msd,
    "mq2008": mq2008,
    "image_embeddings": image_embeddings,
}


def load(name: str, scale: float = 1.0, seed: int | None = None) -> Dataset:
    """Dataset `name` of `REGISTRY` at `scale`, from `seed` (each
    generator's own default seed when None)."""
    kw = {} if seed is None else {"seed": seed}
    return REGISTRY[name](scale=scale, **kw)
