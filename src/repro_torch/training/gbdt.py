"""Quantized-first GBDT training: boosting over a `QuantizedPool`.

The port's counterpart of `src/repro/training/gbdt.py`:

  * ingest   a `QuantizedPool` (`fit_pool`: one byte per (sample,
             feature), zero binarize dispatches while boosting) or a raw
             int32 bins matrix past 255 borders (`fit_bins`)
  * grow     per level, the gradient/hessian histogram goes through the
             registered `histogram` op: the CUDA kernel on the card, the
             plain version on the CPU.  Gradients and hessians sit side by
             side on the stats axis, so both cost one pass, and level d
             sizes its histogram to the 2^d leaves that exist
  * serve    the fitted `ObliviousEnsemble` goes straight into
             `Predictor.build(strategy="staged", layout="soa")`, and the
             reported training-time predictions are that plan's own
             `raw(pool)`, so train->serve parity is exact

The per-tree math is the JAX package's: the same split gains, Newton leaf
values and loss-after-update history.  A level's split search is the
registered `split_level` op (one hand-written kernel's three launches on
the card, where JAX runs plain `jnp`); the leaf update is plain torch, as
it runs outside Pallas in JAX.  f* and b* stay on the device within a
tree, and the host synchronizes once per tree.

Determinism.  A killed run restored from its last checkpoint finishes with
a bit-identical ensemble.  That needs the same bits from every histogram
launch, which the CUDA kernel gives (int64 fixed point); the leaf sums use
the same op, with one all-zero feature and one bin, for the same reason
(`index_add_` on the card adds with float atomics, in no fixed order).

Counting.  The JAX package counts jit traces; the port runs eagerly, so
`history["dispatch_delta"]` counts every registry dispatch (histogram:
depth + 1 per tree, the leaf sums included; split_level: depth per
tree), and the JAX contract of at
most `depth` level-histogram traces becomes the level shapes a fit
launches (`hist_first_calls`, and `TrainingMetrics.hist_dispatches`).  No
trace stands behind it, so it holds by construction: level d has 2^d
leaves, so a fit that grows any tree launches exactly `depth` shapes.

Stage times are CUDA events on the card, read after the tree's one
synchronization (an explicit `torch.cuda.synchronize`), and the host
clock on the CPU.  While the tracer is enabled the same times become
`train/level` and `train/iteration` complete events, emitted after that
synchronization, so tracing adds none; two live host spans time the host
itself: `trainer/split`, issuing a level's split search, and
`trainer/sync`, the iteration's host work after its synchronization,
while the card waits.

`fit_source` streams a `scoring.RowSource` into a pool chunk by chunk
(borders from a reservoir sample, then the bins on the device) and boosts
on it.

The RNG stream is the JAX trainer's (`core.prng`): the carried key
splits into (key, sub, sub2) every tree, `rsm < 1` masks the split
search to the first max(1, int(F * rsm)) features of `permutation(sub,
F)` (drawn on the host, a few dozen features), and ordered boosting
updates the raw predictions along `permutation(sub2, N)` on the
trainer's device.  `TrainState` checkpoints the carried key, so a
checkpoint of either package resumes in the other on the same stream.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core import predictor as predictor_mod
from repro_torch.core import prng, quantize
from repro_torch.core.boosting import BoostingParams, _ordered_update
from repro_torch.core.trees import ObliviousEnsemble
from repro_torch.kernels import ops, registry, tuning
from repro_torch.obs.trace import get_tracer
from repro_torch.serving.metrics import PercentileReservoir
from repro_torch.training.checkpoint import CheckpointManager

_TRACER = get_tracer()


# --------------------------------------------------------------------------
# Observability
# --------------------------------------------------------------------------
class TrainingMetrics:
    """Per-iteration training observability, with the JAX package's keys.

    Stage timings flow through `PercentileReservoir`, throughput is
    `rows_per_s` (sample-rows per boosting iteration, N rows x T
    iterations), as `ServerMetrics` reports serving.  The chunked-ingest
    keys (`quantize_s`, `n_chunks`, `chunk_rows`) are filled by
    `fit_source`."""

    MAX_SAMPLES = 8192

    def __init__(self, name: str = "gbdt"):
        self.name = name
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.iterations = 0
        self.rows_trained = 0
        self.quantize_s = 0.0
        self.n_chunks = 0
        self.chunk_rows = 0
        self.hist_dispatches = 0
        self.train_loss: list[float] = []
        self._iter = PercentileReservoir(self.MAX_SAMPLES)
        self._hist = PercentileReservoir(self.MAX_SAMPLES, seed=1)
        self._split = PercentileReservoir(self.MAX_SAMPLES, seed=2)
        self._leaf = PercentileReservoir(self.MAX_SAMPLES, seed=3)
        self._busy = {"hist": 0.0, "split": 0.0, "leaf": 0.0, "iter": 0.0}

    def note_quantize(self, seconds: float, n_chunks: int,
                      chunk_rows: int) -> None:
        with self._lock:
            self.quantize_s += seconds
            self.n_chunks += n_chunks
            self.chunk_rows = chunk_rows

    def note_iteration(self, n_rows: int, hist_s: float, split_s: float,
                       leaf_s: float, iter_s: float,
                       loss_value: float) -> None:
        with self._lock:
            self.iterations += 1
            self.rows_trained += n_rows
            self.train_loss.append(float(loss_value))
            self._iter.add(iter_s)
            self._hist.add(hist_s)
            self._split.add(split_s)
            self._leaf.add(leaf_s)
            self._busy["hist"] += hist_s
            self._busy["split"] += split_s
            self._busy["leaf"] += leaf_s
            self._busy["iter"] += iter_s

    def note_hist_dispatches(self, n: int) -> None:
        with self._lock:
            self.hist_dispatches += n

    def snapshot(self) -> dict[str, Any]:
        """One flat dict, in the shape of `ServerMetrics.snapshot`."""
        with self._lock:
            dt = max(time.perf_counter() - self._t0, 1e-9)
            busy = max(self._busy["iter"], 1e-9)

            def p(res: PercentileReservoir, q: float) -> float:
                return res.percentile(q) * 1e3 if res.seen else 0.0

            return {
                "model": self.name,
                "iterations": self.iterations,
                "rows_trained": self.rows_trained,
                "rows_per_s": self.rows_trained / dt,
                "iter_p50_ms": p(self._iter, 50),
                "iter_p99_ms": p(self._iter, 99),
                "hist_p50_ms": p(self._hist, 50),
                "split_p50_ms": p(self._split, 50),
                "leaf_p50_ms": p(self._leaf, 50),
                "hist_frac": self._busy["hist"] / busy,
                "split_frac": self._busy["split"] / busy,
                "leaf_frac": self._busy["leaf"] / busy,
                "first_train_loss": (self.train_loss[0]
                                     if self.train_loss else float("nan")),
                "final_train_loss": (self.train_loss[-1]
                                     if self.train_loss else float("nan")),
                "quantize_s": self.quantize_s,
                "n_chunks": self.n_chunks,
                "chunk_rows": self.chunk_rows,
                "hist_dispatches": self.hist_dispatches,
            }


# --------------------------------------------------------------------------
# Checkpointable boosting state
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TrainState:
    """Everything a resumed run needs to finish bit-identically; the JAX
    package's `TrainState`, field for field.  `raw` holds the accumulated
    train-time predictions, `key` the carried RNG key, already split
    `iteration` times."""

    iteration: int
    key: np.ndarray                # (2,) uint32 carried PRNG key
    split_features: np.ndarray     # (k, D) int32
    split_bins: np.ndarray         # (k, D) int32
    leaf_values: np.ndarray        # (k, L, C) float32
    raw: np.ndarray                # (N, C) float32
    train_loss: np.ndarray         # (k,) float32

    def tree(self) -> dict[str, np.ndarray]:
        return {
            "iteration": np.asarray(self.iteration, np.int64),
            "key": np.asarray(self.key),
            "split_features": np.asarray(self.split_features, np.int32),
            "split_bins": np.asarray(self.split_bins, np.int32),
            "leaf_values": np.asarray(self.leaf_values, np.float32),
            "raw": np.asarray(self.raw, np.float32),
            "train_loss": np.asarray(self.train_loss, np.float32),
        }

    @classmethod
    def from_tree(cls, tree: dict[str, np.ndarray]) -> "TrainState":
        return cls(iteration=int(tree["iteration"]),
                   key=np.asarray(tree["key"]),
                   split_features=np.asarray(tree["split_features"]),
                   split_bins=np.asarray(tree["split_bins"]),
                   leaf_values=np.asarray(tree["leaf_values"]),
                   raw=np.asarray(tree["raw"]),
                   train_loss=np.asarray(tree["train_loss"]))


# --------------------------------------------------------------------------
# Per-stage functions
# --------------------------------------------------------------------------
def _grad_stack(raw, y, *, loss):
    """(N, C) g and (N, C) h side by side -> (N, 2C): one histogram pass
    accumulates both."""
    g, h = loss.grad_hess(raw, y)
    return torch.cat([g, h], dim=1).contiguous()


def _hist_level(bins_t, leaf, gh, *, n_bins, n_leaves, backend):
    """The level's (F, n_leaves * n_bins, 2C) histogram."""
    return ops.histogram(bins_t, leaf, gh, n_bins=n_bins, n_leaves=n_leaves,
                         backend=backend)


def _split_level(hist, valid, bins_t, leaf, *, n_bins, d, l2):
    """Pick the level's oblivious split from the (F, 2^d * n_bins, 2C)
    histogram and refine the leaf ids -> (f*, b*, leaf ids): the
    registered `split_level` op, the CUDA kernel on the card and the
    plain version on the CPU, both with the JAX package's gain math and
    its sums in the order of its compiled split step (`split_sums`).

    A split needs hessian mass on both sides; when every gain is masked,
    argmax gives (0, 0) and every sample goes right.  argmax takes the
    first maximum over (F, n_bins) flattened in that order, so gains
    that tie exactly resolve as in JAX."""
    return registry.dispatch("split_level", "auto", hist, valid, bins_t,
                             leaf, n_bins=n_bins, d=d, l2=l2)


def _leaf_values(gh, leaf, leaf_bins, *, n_leaves, lr, l2, backend):
    """(L, C) Newton leaf values from the per-leaf sums: the histogram of
    `leaf_bins`, one all-zero feature, at one bin, (1, L, 2C)."""
    c = gh.shape[1] // 2
    s = ops.histogram(leaf_bins, leaf, gh, n_bins=1, n_leaves=n_leaves,
                      backend=backend)[0]                      # (L, 2C)
    return -lr * s[:, :c] / (s[:, c:] + l2)


def _finish_plain(raw, y, gh, leaf, leaf_bins, *, loss, n_leaves, lr, l2,
                  backend):
    """Leaf values, the raw update and the loss after it."""
    w = _leaf_values(gh, leaf, leaf_bins, n_leaves=n_leaves, lr=lr, l2=l2,
                     backend=backend)
    raw = raw + w[leaf.long()]
    return raw, w, loss.value(raw, y)


def _finish_ordered(raw, y, gh, leaf, leaf_bins, key, *, loss, n_leaves,
                    lr, l2, backend):
    """`_finish_plain` under ordered boosting: each sample's update is its
    prefix Newton step along `key`'s permutation (`_ordered_update`); the
    stored leaf values still use all samples."""
    w = _leaf_values(gh, leaf, leaf_bins, n_leaves=n_leaves, lr=lr, l2=l2,
                     backend=backend)
    c = gh.shape[1] // 2
    raw = raw + _ordered_update(leaf, gh[:, :c], gh[:, c:], key, lr, l2)
    return raw, w, loss.value(raw, y)


def _feat_mask(key, n_features: int, keep: int,
               device: torch.device) -> torch.Tensor:
    """(F,) bool: the first `keep` features of `permutation(key, F)`,
    drawn on the host and copied to `device` without a sync."""
    mask = torch.zeros(n_features, dtype=torch.bool)
    mask[prng.permutation(key, n_features)[:keep]] = True
    return mask.to(device, non_blocking=True)


class _StageClock:
    """Seconds per stage of one tree: CUDA events on the card, read after
    the tree's synchronization; the host clock on the CPU, where every op
    has finished when it returns.  Each mark also keeps the host time it
    was made, which places the stage on a trace's timeline."""

    def __init__(self, device: torch.device):
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        self._marks: list[tuple[Optional[str], int, Any]] = []

    def mark(self, stage: Optional[str]) -> None:
        """Start `stage` (None ends the last one)."""
        event = None
        if self._stream is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record(self._stream)
        self._marks.append((stage, time.perf_counter_ns(), event))

    def stages(self) -> list[tuple[str, int, float]]:
        """(stage, host start in ns, seconds) of each stage, in order."""
        out = []
        for (stage, h0, e0), (_, h1, e1) in zip(self._marks,
                                                 self._marks[1:]):
            dt = (h1 - h0) / 1e9 if e0 is None else e0.elapsed_time(e1) / 1e3
            out.append((stage, h0, dt))
        return out

    def seconds(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for stage, _, dt in self.stages():
            out[stage] = out.get(stage, 0.0) + dt
        return out


def _trace_tree(it: int, rows: int, stages: list[tuple[str, int, float]],
                loss: float, on_card: bool) -> None:
    """`train/level` and `train/iteration` complete events of one tree,
    from its stage clock after the tree's synchronization: host start
    times, and durations from CUDA events on the card (also as
    `device_ms`) or the host clock on the CPU."""
    *levels, (_, _, leaf_s) = stages
    hist_s = split_s = 0.0
    for d in range(len(levels) // 2):
        (_, start_ns, h), (_, _, sp) = levels[2 * d], levels[2 * d + 1]
        hist_s, split_s = hist_s + h, split_s + sp
        extra = {"device_ms": (h + sp) * 1e3} if on_card else {}
        _TRACER.complete("train/level", "train", start_ns=start_ns,
                         duration_ns=int((h + sp) * 1e9), iteration=it,
                         level=d, leaves=1 << d, hist_ms=h * 1e3,
                         split_ms=sp * 1e3, **extra)
    total = hist_s + split_s + leaf_s
    extra = {"device_ms": total * 1e3} if on_card else {}
    _TRACER.complete("train/iteration", "train",
                     start_ns=stages[0][1],
                     duration_ns=int(total * 1e9), iteration=it, rows=rows,
                     hist_ms=hist_s * 1e3, split_ms=split_s * 1e3,
                     leaf_ms=leaf_s * 1e3, loss=loss, **extra)


# --------------------------------------------------------------------------
# Trainer
# --------------------------------------------------------------------------
class GBDTTrainer:
    """Quantized-first boosting: `fit_pool` / `fit_bins`.

    Runs on `device` (the card by default; a machine without one raises
    unless the caller passes ``device="cpu"``).  `backend` is a registry
    backend: `auto` (the CUDA kernels on the card, the plain versions on
    the CPU), `cuda` or `torch_ref`.  One trainer owns one
    `TrainingMetrics`."""

    def __init__(self, loss: losses_lib.Loss, params: BoostingParams, *,
                 backend: str = "auto", device: torch.device | str = "cuda",
                 name: str = "gbdt"):
        backends = ("auto",) + registry.known_backends()
        if backend not in backends:
            raise ValueError(f"backend must be one of {backends}, "
                             f"got {backend!r}")
        self.device = predictor_mod.resolve_device(device)
        registry.check_backend(
            registry.default_backend(self.device) if backend == "auto"
            else backend, self.device)
        self.loss = loss
        self.params = params
        self.backend = backend
        self.metrics = TrainingMetrics(name)
        # the pool of the last `fit_pool` / `fit_source`, and the staged
        # soa plan of the last fit on a pool (the handoff)
        self.pool_: Optional[quantize.QuantizedPool] = None
        self.plan_: Optional[predictor_mod.Predictor] = None

    # -- entry points ------------------------------------------------------
    def fit_pool(self, pool: quantize.QuantizedPool, y, *, borders,
                 n_borders=None,
                 checkpoint: Optional[CheckpointManager] = None,
                 checkpoint_every: int = 0,
                 resume_from: Optional[int] = None
                 ) -> tuple[ObliviousEnsemble, dict]:
        """Train on an existing uint8 pool: zero binarize dispatches."""
        fp = quantize.borders_fingerprint(borders)
        if pool.fingerprint != fp:
            raise ValueError(
                f"pool was quantized under a different schema: pool "
                f"fingerprint {pool.fingerprint} != borders {fp}")
        self.pool_ = pool
        return self._fit_bins(pool.bins, y, borders=borders,
                              n_borders=n_borders, pool=pool,
                              checkpoint=checkpoint,
                              checkpoint_every=checkpoint_every,
                              resume_from=resume_from)

    def fit_bins(self, bins, y, *, borders, n_borders=None,
                 checkpoint: Optional[CheckpointManager] = None,
                 checkpoint_every: int = 0,
                 resume_from: Optional[int] = None
                 ) -> tuple[ObliviousEnsemble, dict]:
        """Train on a raw (N, F) int32/uint8 bins matrix: the escape
        hatch for > 255 borders, where no uint8 pool can exist."""
        return self._fit_bins(torch.as_tensor(bins), y, borders=borders,
                              n_borders=n_borders, pool=None,
                              checkpoint=checkpoint,
                              checkpoint_every=checkpoint_every,
                              resume_from=resume_from)

    def fit_source(self, source, y, *, max_bins: Optional[int] = None,
                   chunk_rows: int = 0, sample_rows: int = 65536,
                   checkpoint: Optional[CheckpointManager] = None,
                   checkpoint_every: int = 0,
                   resume_from: Optional[int] = None
                   ) -> tuple[ObliviousEnsemble, dict]:
        """Out-of-core ingest: stream a `scoring.RowSource` chunk by chunk
        through `quantize_pool_chunked` onto the trainer's device, then
        boost on the pool.

        Float rows exist one chunk at a time (the `BulkScorer` memory
        contract); the retained representation is one byte per (sample,
        feature).  Two streaming passes: the borders (a reservoir sample,
        `compute_borders_chunked`) and the bins."""
        from repro_torch.scoring import sources as sources_lib

        if max_bins is None:
            max_bins = self.params.max_bins
        if chunk_rows <= 0:
            chunk_rows = tuning.best_chunk_rows(source.n_features, 1)
        t0 = time.perf_counter()
        borders, n_borders = quantize.compute_borders_chunked(
            sources_lib.iter_chunks(source, chunk_rows), max_bins,
            sample_rows=sample_rows)
        pool = quantize.quantize_pool_chunked(
            sources_lib.iter_chunks(source, chunk_rows), borders,
            backend=self.backend, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n_chunks = -(-source.n_rows // chunk_rows)
        self.metrics.note_quantize(time.perf_counter() - t0, n_chunks,
                                   chunk_rows)
        ens, history = self.fit_pool(pool, y, borders=borders,
                                     n_borders=n_borders,
                                     checkpoint=checkpoint,
                                     checkpoint_every=checkpoint_every,
                                     resume_from=resume_from)
        history["chunk_rows"] = chunk_rows
        history["n_chunks"] = n_chunks
        return ens, history

    # -- core loop ---------------------------------------------------------
    def _fit_bins(self, bins, y, *, borders, n_borders, pool,
                  checkpoint, checkpoint_every, resume_from):
        p, loss, dev = self.params, self.loss, self.device
        bins = bins.to(dev).contiguous()
        n, n_feat = bins.shape
        yt = losses_lib.as_labels(y, dev)
        raw0 = loss.init_raw(yt)
        c = raw0.shape[1]
        depth, n_leaves = p.depth, 1 << p.depth
        borders = torch.as_tensor(borders, dtype=torch.float32).cpu()
        n_bins = borders.shape[0] + 1
        if n_borders is None:
            n_borders = torch.isfinite(borders).sum(0)
        n_borders = torch.as_tensor(n_borders).to(torch.int32).cpu()
        bins_t = bins.t().contiguous()    # feature-major, once per fit
        b_iota = torch.arange(n_bins, dtype=torch.int32, device=dev)
        # valid split borders: 1 <= b <= n_borders[f]
        base_valid = (b_iota[None, :] >= 1) \
            & (b_iota[None, :] <= n_borders.to(dev)[:, None])
        leaf_bins = torch.zeros((1, n), dtype=torch.uint8, device=dev)

        stats0 = registry.call_stats()

        # resume: restore the carried key / raw / ensemble-so-far
        sf_rows: list[np.ndarray] = []
        sb_rows: list[np.ndarray] = []
        lv_rows: list[np.ndarray] = []
        loss_vals: list[float] = []
        start = 0
        key = prng.initial_key(p.seed)
        raw = raw0
        if checkpoint is not None and resume_from is not None:
            step = None if resume_from < 0 else resume_from
            state = TrainState.from_tree(checkpoint.restore(step))
            if state.raw.shape != (n, c):
                raise ValueError(
                    f"checkpoint raw shape {state.raw.shape} does not "
                    f"match this dataset ({(n, c)})")
            if state.iteration > p.n_trees:
                raise ValueError(
                    f"checkpoint is at iteration {state.iteration} > "
                    f"n_trees {p.n_trees}")
            start = state.iteration
            key = state.key
            raw = torch.from_numpy(np.array(state.raw, np.float32)).to(dev)
            sf_rows = list(state.split_features)
            sb_rows = list(state.split_bins)
            lv_rows = list(state.leaf_values)
            loss_vals = [float(v) for v in state.train_loss]

        level_shapes: set[int] = set()    # leaves of each level launched
        keep = max(1, int(n_feat * p.rsm))
        finish = dict(loss=loss, n_leaves=n_leaves, lr=p.learning_rate,
                      l2=p.l2_reg, backend=self.backend)
        for it in range(start, p.n_trees):
            t_iter = time.perf_counter()
            key, sub, sub2 = prng.split(key, 3)
            valid = (base_valid if p.rsm >= 1.0 else
                     base_valid & _feat_mask(sub, n_feat, keep, dev)[:, None])
            clock = _StageClock(dev)
            gh = _grad_stack(raw, yt, loss=loss)
            leaf = torch.zeros((n,), dtype=torch.int32, device=dev)
            sf_d: list[torch.Tensor] = []
            sb_d: list[torch.Tensor] = []
            for d in range(depth):
                clock.mark("hist")
                hist = _hist_level(bins_t, leaf, gh, n_bins=n_bins,
                                   n_leaves=1 << d, backend=self.backend)
                level_shapes.add(1 << d)
                clock.mark("split")
                if not _TRACER.enabled:
                    f_star, b_star, leaf = _split_level(
                        hist, valid, bins_t, leaf, n_bins=n_bins, d=d,
                        l2=p.l2_reg)
                else:
                    with _TRACER.span("trainer/split", "trainer",
                                      iteration=it, level=d):
                        f_star, b_star, leaf = _split_level(
                            hist, valid, bins_t, leaf, n_bins=n_bins, d=d,
                            l2=p.l2_reg)
                sf_d.append(f_star)
                sb_d.append(b_star)
            clock.mark("leaf")
            if p.ordered:
                raw, w, val = _finish_ordered(raw, yt, gh, leaf, leaf_bins,
                                              sub2, **finish)
            else:
                raw, w, val = _finish_plain(raw, yt, gh, leaf, leaf_bins,
                                            **finish)
            clock.mark(None)
            if dev.type == "cuda":
                # the tree's one synchronization with the host: the
                # copies below then wait for nothing
                torch.cuda.synchronize(dev)
            # from here to the iteration's end the card has nothing queued
            with _TRACER.span("trainer/sync", "trainer", iteration=it):
                splits = (torch.stack(sf_d + sb_d).cpu().numpy() if depth
                          else np.zeros((0,), np.int32))
                sf_rows.append(splits[:depth].astype(np.int32))
                sb_rows.append(splits[depth:].astype(np.int32))
                lv_rows.append(w.cpu().numpy().astype(np.float32))
                loss_vals.append(float(val))
                t_end = time.perf_counter()
                stage = clock.seconds()
                if _TRACER.enabled:
                    _trace_tree(it, n, clock.stages(), loss_vals[-1],
                                dev.type == "cuda")
                self.metrics.note_iteration(n, stage.get("hist", 0.0),
                                            stage.get("split", 0.0),
                                            stage.get("leaf", 0.0),
                                            t_end - t_iter, loss_vals[-1])
                done = it + 1
                if checkpoint is not None and checkpoint_every > 0 and (
                        done % checkpoint_every == 0 or done == p.n_trees):
                    checkpoint.save(done, TrainState(
                        iteration=done, key=np.asarray(key),
                        split_features=np.stack(sf_rows),
                        split_bins=np.stack(sb_rows),
                        leaf_values=np.stack(lv_rows),
                        raw=raw.cpu().numpy(),
                        train_loss=np.asarray(loss_vals, np.float32)).tree())
        if checkpoint is not None:
            checkpoint.wait()

        n_trees = len(sf_rows)
        ensemble = ObliviousEnsemble(
            split_features=(np.stack(sf_rows) if n_trees
                            else np.zeros((0, depth), np.int32)),
            split_bins=(np.stack(sb_rows) if n_trees
                        else np.zeros((0, depth), np.int32)),
            leaf_values=(np.stack(lv_rows) if n_trees
                         else np.zeros((0, n_leaves, c), np.float32)),
            borders=borders, n_borders=n_borders,
            base_score=raw0[0].cpu())

        # Closed train->serve loop: the reported training-time predictions
        # are a serving plan's output on the training pool, so a fresh
        # `Predictor.build` gives them exactly.  The int32 escape hatch
        # (no pool) evaluates through the same staged ops instead.
        if pool is not None:
            self.plan_ = predictor_mod.Predictor.build(
                ensemble, strategy="staged", layout="soa",
                backend=self.backend, device=dev)
            final_raw = self.plan_.raw(pool)
        else:
            on_dev = ensemble.to(dev)
            idx = ops.leaf_index(bins, on_dev.split_features,
                                 on_dev.split_bins, backend=self.backend)
            final_raw = raw0[:1] + ops.leaf_gather(
                idx, on_dev.leaf_values, backend=self.backend)

        delta = {op: k - stats0.get(op, 0)
                 for op, k in registry.call_stats().items()
                 if k != stats0.get(op, 0)}
        self.metrics.note_hist_dispatches(len(level_shapes))
        final_np = final_raw.cpu().numpy().astype(np.float32)
        history = {
            "train_loss": np.asarray(loss_vals, np.float32),
            "final_metric": float(loss.metric(raw, yt)),
            "final_raw": final_np,
            # float-association drift between the accumulated training
            # raw and the served re-score
            "serve_drift": float(np.max(np.abs(
                final_np - raw.cpu().numpy()))) if n_trees else 0.0,
            "dispatch_delta": delta,
            "hist_first_calls": len(level_shapes),
            "metrics": self.metrics.snapshot(),
        }
        return ensemble, history
