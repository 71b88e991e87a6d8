"""kNN embedding featurizer (paper: image-embeddings workload) on the card.

The port's counterpart of `src/repro/core/knn.py`.  CatBoost's embedding
features run kNN over stored training embeddings; the hotspot is
L2SqrDistance (paper Table 4: 91.6% of total time before vectorization).
Features produced per query embedding:
  - per-class fraction among the k nearest neighbours   (C features)
  - mean distance to the k nearest                      (1 feature)

The distances come from the `l2sq` op: the matrix kernel by default (the
batched form), or with `rowwise=True` one dispatch and one launch of the
paper-faithful rowwise kernel per query, each writing its row of a
preallocated (Q, M) buffer, the queries and references checked once
(`ops.rowwise_batch`).

Neighbours are chosen as `jax.lax.top_k(-dists, k)` chooses them: the k
smallest distances, and among equal distances the lower reference index
first.  `torch.topk` gives no such order, so the port takes the first k
of a stable ascending sort.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.predictor import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(eq=False)
class KNNFeaturizer:
    """The reference set (embeddings and labels) on `device`, the card
    unless the caller passes "cpu"; arrays are moved there once."""
    train_embeddings: torch.Tensor    # (M, K) float32
    train_labels: torch.Tensor        # (M,) int32
    n_classes: int
    k: int = 16
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.train_embeddings = torch.as_tensor(
            self.train_embeddings, dtype=torch.float32).to(
                self.device).contiguous()
        self.train_labels = torch.as_tensor(
            self.train_labels, dtype=torch.int32).to(self.device)
        m = self.train_embeddings.shape[0]
        if self.train_embeddings.ndim != 2 or \
                tuple(self.train_labels.shape) != (m,):
            raise ValueError(
                f"expected train embeddings (M, K) and labels (M,), got "
                f"{tuple(self.train_embeddings.shape)} and "
                f"{tuple(self.train_labels.shape)}")
        if not 1 <= self.k <= m:
            raise ValueError(f"k must lie in [1, {m}] (the reference "
                             f"rows), got {self.k}")

    @property
    def n_features(self) -> int:
        return self.n_classes + 1

    def transform(self, queries, *, backend: str = "auto",
                  rowwise: bool = False, batch_size: int = 4096
                  ) -> torch.Tensor:
        """(Q, K) embeddings -> (Q, n_classes + 1) kNN features, on the
        featurizer's device."""
        q_all = torch.as_tensor(queries, dtype=torch.float32,
                                device=self.device)
        if q_all.ndim != 2 or \
                q_all.shape[1] != self.train_embeddings.shape[1]:
            raise ValueError(
                f"expected (Q, {self.train_embeddings.shape[1]}) queries, "
                f"got {tuple(q_all.shape)}")
        q_all = q_all.contiguous()
        refs = self.train_embeddings
        # the rowwise route checks the queries and refs once, then makes
        # one dispatch and one launch a query into a preallocated row
        run = ops.rowwise_batch(q_all, refs, backend=backend) \
            if rowwise else None
        outs = []
        for s in range(0, q_all.shape[0], batch_size):
            q = q_all[s:s + batch_size]
            if rowwise:
                dists = torch.empty((q.shape[0], refs.shape[0]),
                                    dtype=torch.float32, device=self.device)
                for i in range(q.shape[0]):
                    ops.l2sq_rowwise(q[i], refs, backend=backend,
                                     out=dists[i], batch=run)
            else:
                dists = ops.l2sq_matrix(q, refs, backend=backend)
            outs.append(self._features_from_dists(dists))
        if not outs:
            return torch.zeros((0, self.n_features), device=self.device)
        return torch.cat(outs, dim=0)

    def neighbours(self, dists: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(Q, M) distances -> the k nearest as (distances, reference
        indices), each (Q, k): ascending, ties lower index first."""
        d, idx = torch.sort(dists, dim=1, stable=True)
        return d[:, :self.k], idx[:, :self.k]

    def _features_from_dists(self, dists: torch.Tensor) -> torch.Tensor:
        top, nbr_idx = self.neighbours(dists)
        nbr_labels = self.train_labels[nbr_idx]                 # (Q, k)
        classes = torch.arange(self.n_classes, device=dists.device,
                               dtype=torch.int32)
        counts = (nbr_labels[:, :, None] == classes).sum(dim=1)  # (Q, C)
        # jnp.mean over k: XLA divides by multiplying with 1/k in float32
        # (torch casts the scalar to float32 too)
        inv_k = 1.0 / self.k
        frac = counts.to(torch.float32) * inv_k
        mean_dist = top.sum(dim=1, keepdim=True) * inv_k
        return torch.cat([frac, mean_dist], dim=1)


def augment_with_knn(x: np.ndarray, emb: np.ndarray,
                     featurizer: KNNFeaturizer, **kw) -> np.ndarray:
    """Concatenate tabular features with kNN features over embeddings."""
    feats = featurizer.transform(np.asarray(emb, np.float32), **kw)
    return np.concatenate([np.asarray(x, np.float32),
                           feats.cpu().numpy()], axis=1)
