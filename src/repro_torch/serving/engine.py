"""GBDT serving engine over a prepared prediction plan.

The port's counterpart of `GBDTServer` and `EmbeddingGBDTPipeline` in
`src/repro/serving/engine.py`.  Request aggregation and bucket padding
live in `serving.batching`, per-model counters in `serving.metrics`.
Mesh serving, replica groups, the model registry and bulk scoring are not
ported yet.
"""
from __future__ import annotations

import queue
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.knn import KNNFeaturizer
from repro_torch.core.predictor import (PredictConfig, Predictor,
                                        resolve_device)
from repro_torch.core.quantize import QuantizedPool
from repro_torch.core.trees import ObliviousEnsemble
from repro_torch.serving.batching import BucketedBatcher, bucket_for, chunks
from repro_torch.serving.metrics import ServerMetrics


class GBDTServer:
    """Batched GBDT scoring service over one `Predictor`.

    The server builds its plan once, on `device` (the card unless the
    caller passes "cpu"), and scores every batch through it.  Each batch
    the batcher flushes is padded up to one of ``buckets`` first, so the
    plan's first-call counter, reported as `metrics.recompiles`, stays
    bounded by the bucket count.

    Quantized-first path: ``quantize(xs)`` binarizes a batch once into a
    `QuantizedPool`; ``predict_pool(pool)`` scores it with no binarize.

    ``config_kw`` goes to `PredictConfig` (``layout="bitpacked"``,
    ``strategy="staged"``, ...); ``metrics.layout`` reports the layout the
    plan resolved to, and both paths score through that layout's kernels.
    """

    def __init__(self, ensemble: ObliviousEnsemble, *,
                 config: Optional[PredictConfig] = None,
                 device: torch.device | str = "cuda",
                 mesh=None, max_batch: int = 256,
                 max_wait_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None,
                 min_bucket: int = 16,
                 name: str = "gbdt",
                 deadline_ms: Optional[float] = None,
                 **config_kw: Any):
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        self.ensemble = ensemble
        self.metrics = ServerMetrics(name, deadline_ms=deadline_ms)
        self.predictor = Predictor.build(ensemble, config, device=device,
                                         on_trace=self.metrics.note_trace,
                                         **config_kw)
        self.metrics.layout = self.predictor.config.layout

        def serve(xs: np.ndarray) -> np.ndarray:
            return self.predictor.proba(xs).cpu().numpy()

        self.batcher = BucketedBatcher(serve, max_batch=max_batch,
                                       max_wait_ms=max_wait_ms,
                                       buckets=buckets,
                                       min_bucket=min_bucket,
                                       metrics=self.metrics)

    @property
    def config(self) -> PredictConfig:
        """The resolved plan configuration this server scores with."""
        return self.predictor.config

    @property
    def buckets(self) -> tuple[int, ...]:
        return self.batcher.buckets

    @property
    def schema_fingerprint(self) -> str:
        """Which `QuantizedPool`s this server may score."""
        return self.predictor.schema_fingerprint

    def predict(self, x: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        """Single request through the deadline batcher (blocking).  A
        timeout counts as a shed request and raises `TimeoutError`."""
        fut = self.batcher.submit(0, np.asarray(x, np.float32))
        try:
            return fut.get(timeout=timeout)
        except queue.Empty:
            self.metrics.note_shed()
            raise TimeoutError(
                f"predict timed out after {timeout}s (counted as shed; "
                "batcher queue may be saturated)") from None

    def predict_batch(self, xs: np.ndarray) -> np.ndarray:
        """Synchronous bulk scoring through the same bucketed path:
        oversized inputs are chunked at the largest bucket."""
        xs = np.asarray(xs, np.float32)
        if len(xs) == 0:
            return self._empty_proba()
        top = self.buckets[-1]
        out = [self.batcher._run_batch(xs[start:stop])
               for start, stop in chunks(len(xs), top)]
        return np.concatenate(out, axis=0)

    def quantize(self, xs) -> QuantizedPool:
        """Binarize a batch once (on the server's device) for reuse."""
        return self.predictor.quantize(np.asarray(xs, np.float32))

    def predict_pool(self, pool: QuantizedPool) -> np.ndarray:
        """Synchronous bulk scoring of a pre-quantized pool: binarize
        never runs.  Chunks at the largest bucket and pads each chunk up
        to a bucket, recording each in `metrics` like a float batch."""
        if len(pool) == 0:
            return self._empty_proba()
        top = self.buckets[-1]
        out = []
        for start, stop in chunks(len(pool), top):
            chunk = pool.slice_rows(start, stop)
            bucket = bucket_for(len(chunk), self.buckets)
            t0 = time.perf_counter()
            ys = self.predictor.proba(chunk.pad_rows(bucket)).cpu().numpy()
            self.metrics.note_batch(len(chunk), bucket,
                                    time.perf_counter() - t0)
            out.append(ys[:len(chunk)])
        return np.concatenate(out, axis=0)

    def _empty_proba(self) -> np.ndarray:
        width = 2 if self.ensemble.n_outputs == 1 else \
            self.ensemble.n_outputs
        return np.zeros((0, width), np.float32)

    def close(self):
        self.batcher.close()


class EmbeddingGBDTPipeline:
    """backbone embeddings -> kNN features -> GBDT (the paper's
    image-embeddings workload, generalized to any backbone).

    The plan is built on the featurizer's device, which must be `device`
    (the card unless the caller passes "cpu"), with `config`'s choices
    (all `auto` by default: the cuda kernels on the card)."""

    def __init__(self, featurizer: KNNFeaturizer,
                 ensemble: ObliviousEnsemble,
                 embed_fn: Optional[Callable] = None,
                 config: Optional[PredictConfig] = None,
                 device: torch.device | str = "cuda"):
        device = resolve_device(device)
        if featurizer.device != device:
            raise ValueError(f"the featurizer is on {featurizer.device}, "
                             f"the pipeline on {device}")
        self.featurizer = featurizer
        self.ensemble = ensemble
        self.embed_fn = embed_fn          # raw input -> embedding (stub ok)
        self.predictor = Predictor.build(ensemble, config, device=device)

    def predict(self, inputs) -> np.ndarray:
        """Raw inputs (embeddings when there is no `embed_fn`) -> (N,)
        int32 class ids, as numpy."""
        emb = self.embed_fn(inputs) if self.embed_fn is not None else inputs
        emb = torch.as_tensor(emb, dtype=torch.float32,
                              device=self.featurizer.device)
        feats = self.featurizer.transform(emb)
        x = torch.cat([emb, feats], dim=1)
        return self.predictor.classify(x).cpu().numpy()
