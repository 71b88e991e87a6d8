"""GBDT serving engine over a prepared prediction plan.

The port's counterpart of `GBDTServer`, `ModelRegistry` and
`EmbeddingGBDTPipeline` in `src/repro/serving/engine.py`.  Request
aggregation and bucket padding live in `serving.batching`, per-model
counters in `serving.metrics`; `GBDTServer.score_source` hands a whole
dataset to `scoring.BulkScorer`.  A server given ``mesh=`` scores through
`Predictor.sharded`; `ModelRegistry.register(..., replicas=R)` serves a
model from R servers over disjoint submeshes behind a `ReplicaGroup`.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.knn import KNNFeaturizer
from repro_torch.core.predictor import (PredictConfig, Predictor,
                                        proba_from_raw, resolve_device)
from repro_torch.core.quantize import QuantizedPool
from repro_torch.core.trees import ObliviousEnsemble
from repro_torch.distributed.gbdt import replica_submeshes
from repro_torch.obs.trace import get_tracer
from repro_torch.scoring.scorer import BulkScorer, ScoreConfig, ScoreResult
from repro_torch.serving.batching import BucketedBatcher, bucket_for, chunks
from repro_torch.serving.metrics import ServerMetrics

_TRACER = get_tracer()


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

    With ``mesh=`` (a `distributed.mesh.Mesh`) both paths score through
    the plan's `sharded(mesh)` entry, which ships this same lowered model
    to every shard; it runs the staged pipeline unless the config asked
    for a strategy, and the scores come back from the mesh's first
    device.
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
        self.ensemble = ensemble
        self.mesh = mesh
        self.metrics = ServerMetrics(name, deadline_ms=deadline_ms)
        self.predictor = Predictor.build(ensemble, config, device=device,
                                         on_trace=self.metrics.note_trace,
                                         **config_kw)
        self.metrics.layout = self.predictor.config.layout
        self._sharded = None
        if mesh is not None:
            asked = (config.strategy if config is not None
                     else config_kw.get("strategy", "auto"))
            self._sharded = self.predictor.sharded(
                mesh, strategy="staged" if asked == "auto" else asked)

        def serve(xs: np.ndarray) -> np.ndarray:
            # lands on the batcher thread's track in exported traces
            with _TRACER.span("serve/batch", "serve",
                              device=self.predictor.device, model=name,
                              rows=int(len(xs))):
                return self._proba(xs)

        self.batcher = BucketedBatcher(serve, max_batch=max_batch,
                                       max_wait_ms=max_wait_ms,
                                       buckets=buckets,
                                       min_bucket=min_bucket,
                                       metrics=self.metrics)

    @property
    def config(self) -> PredictConfig:
        """The resolved plan configuration this server scores with."""
        return self.predictor.config

    def _proba(self, x) -> np.ndarray:
        """Class probabilities of floats or a pool, through the mesh when
        the server has one, as numpy."""
        if self._sharded is None:
            return self.predictor.proba(x).cpu().numpy()
        raw = self._sharded(x)
        return proba_from_raw(raw, self.ensemble.n_outputs).cpu().numpy()

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
            ys = self._proba(chunk.pad_rows(bucket))
            self.metrics.note_batch(len(chunk), bucket,
                                    time.perf_counter() - t0)
            out.append(ys[:len(chunk)])
        return np.concatenate(out, axis=0)

    def score_source(self, source, sinks=None, *,
                     config: Optional[ScoreConfig] = None,
                     resume_from: int = 0, **score_kw: Any) -> ScoreResult:
        """Bulk-apply this server's plan to a whole dataset: the bridge
        from online serving to offline jobs (a nightly rescore of the
        deployed model, on the same plan).  `source` is a
        `scoring.RowSource`, `sinks` a `ScoreSink` (or None for an
        in-memory array); the `ScoreResult`'s metrics report `rows_per_s`
        in the unit of this server's `metrics.snapshot()`.

        Defaults to ``output="proba"``, what this server's online
        predicts return, unless the config says otherwise.  A mesh server
        scores the job through the same mesh (`BulkScorer(mesh=...)`)."""
        if config is None:
            score_kw.setdefault("output", "proba")
            config = ScoreConfig(**score_kw)
        elif score_kw:
            raise TypeError("pass either a ScoreConfig or config kwargs, "
                            f"not both: {sorted(score_kw)}")
        return BulkScorer(self.predictor, config, mesh=self.mesh).score(
            source, sinks, resume_from=resume_from)

    def _empty_proba(self) -> np.ndarray:
        width = 2 if self.ensemble.n_outputs == 1 else \
            self.ensemble.n_outputs
        return np.zeros((0, width), np.float32)

    def close(self):
        self.batcher.close()


class ReplicaGroup:
    """R `GBDTServer`s over disjoint submeshes, behind one model name.

    Requests round-robin across the replicas; each runs the full sharded
    predict path on its own shards, so a single request sees exactly the
    single-replica parity contract.  The group presents the `GBDTServer`
    scoring surface (`predict`, `predict_batch`, `predict_pool`,
    `quantize`, `schema_fingerprint`, `score_source`), so `ModelRegistry`
    routes to it transparently, and `metrics_snapshot()` is the fleet
    view (`ServerMetrics.merge`).
    """

    def __init__(self, name: str, servers: Sequence[GBDTServer]):
        if not servers:
            raise ValueError("ReplicaGroup needs at least one server")
        self.name = name
        self.servers = list(servers)
        self._rr = 0
        self._rr_lock = threading.Lock()

    def _next(self) -> GBDTServer:
        with self._rr_lock:
            server = self.servers[self._rr % len(self.servers)]
            self._rr += 1
        return server

    # -- GBDTServer surface -------------------------------------------------
    @property
    def ensemble(self) -> ObliviousEnsemble:
        return self.servers[0].ensemble

    @property
    def mesh(self):
        return self.servers[0].mesh

    @property
    def schema_fingerprint(self) -> str:
        return self.servers[0].schema_fingerprint

    def quantize(self, xs) -> QuantizedPool:
        # the replicas share borders (one ensemble), so a pool quantized
        # once scores on any of them
        return self.servers[0].quantize(xs)

    def predict(self, x, timeout: float = 30.0) -> np.ndarray:
        return self._next().predict(x, timeout=timeout)

    def predict_batch(self, xs) -> np.ndarray:
        return self._next().predict_batch(xs)

    def predict_pool(self, pool: QuantizedPool) -> np.ndarray:
        return self._next().predict_pool(pool)

    def score_source(self, source, sinks=None, **kw: Any) -> ScoreResult:
        return self._next().score_source(source, sinks, **kw)

    def metrics_snapshot(self) -> dict[str, Any]:
        merged = ServerMetrics.merge([s.metrics for s in self.servers])
        merged["model"] = self.name
        return merged

    def close(self) -> None:
        for s in self.servers:
            s.close()


class ModelRegistry:
    """Several named GBDT ensembles served from one process.

    Each model gets its own `GBDTServer` (its own batcher thread, plan
    and metrics), on the card unless the defaults or `register` pass
    ``device="cpu"``; `metrics()` gathers the per-model snapshots.

    Replica groups: ``register(name, ens, replicas=R)`` with a ``mesh=``
    (to `register` or the registry defaults) splits the mesh into R
    disjoint submeshes (`distributed.gbdt.replica_submeshes`) and serves
    the model from one `GBDTServer` a submesh behind a round-robin
    `ReplicaGroup`: K models x R replicas share one mesh, and
    `predict_multi` still quantizes once per feature schema across all
    of them.

    A plan is immutable: it holds the model lowered for the ensemble it
    was built from.  Swapping the ensemble under a name (``register(...,
    replace=True)``) therefore closes the whole old server and builds a
    new one.
    """

    def __init__(self, **default_server_kw: Any):
        self._default_kw = default_server_kw
        self._servers: dict[str, GBDTServer | ReplicaGroup] = {}

    def register(self, name: str, ensemble: ObliviousEnsemble,
                 replace: bool = False, *, replicas: int = 1,
                 **server_kw: Any) -> GBDTServer | ReplicaGroup:
        if name in self._servers:
            if not replace:
                raise KeyError(f"model {name!r} already registered "
                               "(pass replace=True to swap it)")
            self._servers.pop(name).close()
        kw = {**self._default_kw, **server_kw, "name": name}
        if replicas > 1:
            mesh = kw.pop("mesh", None)
            if mesh is None:
                raise ValueError(
                    "replicas > 1 needs a mesh to split (pass mesh= "
                    "to register() or to the registry defaults)")
            servers = [GBDTServer(ensemble, **{**kw, "mesh": sub,
                                               "name": f"{name}/r{i}"})
                       for i, sub in enumerate(
                           replica_submeshes(mesh, replicas))]
            group = ReplicaGroup(name, servers)
            self._servers[name] = group
            return group
        server = GBDTServer(ensemble, **kw)
        self._servers[name] = server
        return server

    def load(self, name: str, path, **server_kw: Any) -> GBDTServer:
        """Register the ensemble of an `.npz` either package saved."""
        return self.register(name, ObliviousEnsemble.load(path),
                             **server_kw)

    def get(self, name: str) -> GBDTServer | ReplicaGroup:
        if name not in self._servers:
            raise KeyError(f"unknown model {name!r}; registered: "
                           f"{sorted(self._servers)}")
        return self._servers[name]

    def names(self) -> list[str]:
        return sorted(self._servers)

    def predict(self, name: str, x: np.ndarray,
                timeout: float = 30.0) -> np.ndarray:
        return self.get(name).predict(x, timeout=timeout)

    def predict_batch(self, name: str, xs: np.ndarray) -> np.ndarray:
        return self.get(name).predict_batch(xs)

    def predict_multi(self, xs: np.ndarray,
                      names: Optional[Sequence[str]] = None
                      ) -> dict[str, np.ndarray]:
        """Score one batch through several models, quantizing once per
        feature schema: servers whose ensembles share borders (the same
        `schema_fingerprint`) score one `QuantizedPool` through their
        pool path, which never binarizes.  Mesh servers and replica
        groups take the same path: the sharded pool entry row-shards the
        quantized bins, so one quantize covers every model and every
        replica that shares the schema."""
        if names is None:
            names = self.names()
        pools: dict[str, QuantizedPool] = {}
        out: dict[str, np.ndarray] = {}
        for name in names:
            server = self.get(name)
            fp = server.schema_fingerprint
            if fp not in pools:
                pools[fp] = server.quantize(xs)
            out[name] = server.predict_pool(pools[fp])
        return out

    def metrics(self) -> dict[str, dict[str, Any]]:
        return {n: (s.metrics_snapshot() if isinstance(s, ReplicaGroup)
                    else s.metrics.snapshot())
                for n, s in self._servers.items()}

    def unregister(self, name: str) -> None:
        self._servers.pop(name).close()

    def close(self) -> None:
        for s in self._servers.values():
            s.close()
        self._servers.clear()


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
