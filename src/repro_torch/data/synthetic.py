"""Synthetic Covertype workload (the paper's Table 1 row), made with numpy.

The port's copy of `Dataset`, `_class_mixture` and `covertype` from
`src/repro/data/synthetic.py`: the same seed gives bit-identical arrays.

| name      | rows x cols  | classes | loss       | depth | lr  |
|-----------|--------------|---------|------------|-------|-----|
| covertype | 464800 x 54  | 7       | MultiClass | 8     | 0.5 |
"""
from __future__ import annotations

import dataclasses

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
