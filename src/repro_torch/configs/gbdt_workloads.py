"""The paper's own workload configs (Table 1) as selectable configs.

These drive examples/, benchmarks/ and the serving launcher; row counts
are scaled by the harness (synthetic data generators keep the feature
dimensionality, class counts and loss of the originals).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.boosting import BoostingParams


@dataclasses.dataclass(frozen=True)
class GBDTWorkload:
    name: str
    dataset: str                 # repro_torch.data.synthetic registry key
    loss: str
    n_classes: int
    rows_cols: tuple
    params: BoostingParams
    # paper Table 1 sets 10000 max iterations; benchmark presets scale the
    # tree count down for the single-core container (documented)
    paper_iterations: int = 10000


WORKLOADS = {
    "mq2008": GBDTWorkload(
        "mq2008", "mq2008", "yetirank", 0, (9630, 46),
        BoostingParams(depth=6, learning_rate=0.02)),
    "santander": GBDTWorkload(
        "santander", "santander", "logloss", 2, (400_000, 202),
        BoostingParams(depth=1, learning_rate=0.01)),
    "covertype": GBDTWorkload(
        "covertype", "covertype", "multiclass", 7, (464_800, 54),
        BoostingParams(depth=8, learning_rate=0.50)),
    "year_prediction_msd": GBDTWorkload(
        "year_prediction_msd", "year_prediction_msd", "mae", 0,
        (515_345, 90), BoostingParams(depth=6, learning_rate=0.30)),
    "image_embeddings": GBDTWorkload(
        "image_embeddings", "image_embeddings", "multiclass", 20,
        (5_649, 512), BoostingParams(depth=4, learning_rate=0.05)),
}


def get(name: str) -> GBDTWorkload:
    return WORKLOADS[name]
