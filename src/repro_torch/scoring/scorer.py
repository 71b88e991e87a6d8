"""Streaming out-of-core bulk scoring: apply prepared `Predictor` plans to
datasets of any size on the plans' device.

The port's counterpart of `src/repro/scoring/scorer.py`, the paper's
headline workload (`ApplyModelMulti` sweeping a whole dataset through a
prepared ensemble) as a nightly-rescore job.  Its contracts are the JAX
package's:

  * **one fixed chunk shape**: `kernels.tuning.best_chunk_rows` picks one
    power-of-two chunk and the tail is padded to a bucket, so a run feeds
    the plans at most 2 padded shapes whatever the dataset's size;
  * **O(chunk) host memory**: rows are range-read from a `RowSource`,
    quantized a chunk at a time and streamed row-addressed into a
    `ScoreSink`; nothing dataset-sized is ever resident;
  * **quantize once a schema a chunk**: plans that share borders
    (`schema_fingerprint`) score one pool per chunk, binarized once by the
    group's representative plan;
  * **resume by chunk index**: chunk boundaries depend only on (n_rows,
    chunk_rows), so ``resume_from=k`` lands its rows where an interrupted
    run would have (`NpySink(resume=True)` keeps the rows already
    written).

On the card, with chunks of at least `tuning.PREFETCH_MIN_CHUNK_ROWS`
(below it the synchronous path is faster; `tuning.prefetch_depth`), the
pipeline overlaps three things:

  * a `data.pipeline.Prefetcher` worker reads chunk k+1 into a pinned
    host buffer, copies it to the card on a side CUDA stream and binarizes
    it there, records an event and waits for it (its own thread only: the
    quantize time then counts the device work, as the JAX worker's
    `block_until_ready` does, and the pinned buffer is free again);
  * the main thread makes its stream wait on that event (no host block),
    marks the tensors that crossed over with `record_stream`, and
    launches chunk k+1's scoring kernels;
  * chunk k's scores were copied to pinned host buffers on the main
    stream right after its kernels; the main thread waits for that copy
    only after chunk k+1 is launched, then writes the sinks while the card
    scores chunk k+1 (the lag-1 drain).

Synchronously the main thread reads, copies and binarizes each chunk
itself, on the same side stream, and keeps the lag-1 drain.  Only one
thread launches `binarize` in a run (the worker, or the main thread when
there is none), and only the main thread launches the scoring kernels, so
no kernel's launch counter is bumped from two threads.
While the tracer is enabled each chunk records `bulk/quantize` (on the
worker's thread when there is one), `bulk/score` and `bulk/sink`.

With ``mesh=`` every chunk scores through the plans' `sharded(mesh)`
entries: a pool shards its uint8 bins over the mesh's row shards, the
float route binarizes shard by shard, and the worker still binarizes
chunk k+1 while chunk k's shards score.  The chunk shapes and resume are
unchanged; the scores come back to the plans' device.

    cfg    = ScoreConfig(output="proba")
    scorer = BulkScorer(plan, cfg)           # or {"name": plan, ...}
    result = scorer.score(NpyMemmapSource("x.npy"), NpySink("y.npy"))
    result.metrics["rows_per_s"]             # comparable to ServerMetrics
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.predictor import (Predictor, classify_from_raw,
                                        proba_from_raw)
from repro_torch.core.quantize import MAX_BINS, QuantizedPool
from repro_torch.data.pipeline import Prefetcher
from repro_torch.kernels import tuning
from repro_torch.obs.trace import get_tracer
from repro_torch.scoring.sinks import ArraySink, ScoreSink
from repro_torch.scoring.sources import RowSource
from repro_torch.serving.batching import bucket_for, pow2_buckets
from repro_torch.serving.metrics import PercentileReservoir

_TRACER = get_tracer()
_OUTPUTS = ("raw", "proba", "classify")
_FLOAT = "__float__"


@dataclasses.dataclass(frozen=True)
class ScoreConfig:
    """Bulk-scoring configuration.

      chunk_rows      fixed chunk shape; 0 = auto from
                      `tuning.best_chunk_rows` (byte-budgeted pow2)
      output          which plan entry scores: raw | proba | classify
                      (classify lands in sinks as an (N, 1) panel)
      prefetch_depth  chunks in flight ahead of the scorer (the
                      Prefetcher queue bound); 0 = synchronous, no
                      worker thread.  On the card a chunk under
                      `tuning.PREFETCH_MIN_CHUNK_ROWS` runs
                      synchronously (`tuning.prefetch_depth`)
      prequantize     binarize each chunk on the prefetch worker and
                      score uint8 pools; plans whose borders exceed the
                      uint8 cap take the float path per schema
      chunk_budget_bytes   bytes one in-flight chunk may hold, on
                      the host and the card together
                      (`tuning.chunk_row_bytes`; feeds the auto chunk
                      planner)
    """
    chunk_rows: int = 0
    output: str = "proba"
    prefetch_depth: int = 2
    prequantize: bool = True
    chunk_budget_bytes: int = tuning.CHUNK_BUDGET_BYTES

    def __post_init__(self):
        if self.output not in _OUTPUTS:
            raise ValueError(f"output must be one of {_OUTPUTS}, "
                             f"got {self.output!r}")
        if not isinstance(self.chunk_rows, int) or self.chunk_rows < 0:
            raise ValueError(f"chunk_rows must be an int >= 0, "
                             f"got {self.chunk_rows!r}")
        if not isinstance(self.prefetch_depth, int) \
                or self.prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be an int >= 0, "
                             f"got {self.prefetch_depth!r}")
        if self.chunk_budget_bytes < 1:
            raise ValueError("chunk_budget_bytes must be positive")


class ScoringMetrics:
    """Offline counterpart of `serving.metrics.ServerMetrics`: rows/s,
    the quantize-vs-score wall split, chunk count, first calls of the
    plans' entries, and per-chunk latency percentiles through the same
    `PercentileReservoir`, so online and offline dashboards report
    comparable units (`rows_per_s` appears in both snapshots)."""

    def __init__(self, name: str = "bulk"):
        self.name = name
        self._lock = threading.Lock()
        self.rows = 0
        self.padded_rows = 0
        self.chunks = 0
        self.quantize_s = 0.0
        self.score_s = 0.0
        self.wall_s = 0.0
        self.compiles = 0
        self.resumed_from = 0
        self.prefetch_depth = 0
        self._chunk_lat = PercentileReservoir()
        self._t0: Optional[float] = None
        # interval-rate markers: state of the previous snapshot() call
        self._prev_t = time.perf_counter()
        self._prev_rows = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self.wall_s += time.perf_counter() - self._t0
            self._t0 = None

    def note_quantize(self, seconds: float) -> None:
        """Called from the prefetch worker thread."""
        with self._lock:
            self.quantize_s += seconds

    def note_chunk(self, n_valid: int, n_padded: int,
                   score_seconds: float) -> None:
        with self._lock:
            self.chunks += 1
            self.rows += n_valid
            self.padded_rows += n_padded - n_valid
            self.score_s += score_seconds
            self._chunk_lat.add(score_seconds)

    def _locked_snapshot(self, advance_interval: bool) -> dict[str, Any]:
        """Build the snapshot dict; caller holds self._lock.  `wall_s`
        includes the running interval between `start()` and `stop()`."""
        now = time.perf_counter()
        wall = self.wall_s + (now - self._t0
                              if self._t0 is not None else 0.0)
        idt = max(now - self._prev_t, 1e-9)
        busy = self.quantize_s + self.score_s
        pad_total = self.rows + self.padded_rows
        snap = {
            "name": self.name,
            "rows": self.rows,
            "chunks": self.chunks,
            "compiles": self.compiles,
            "resumed_from": self.resumed_from,
            "prefetch_depth": self.prefetch_depth,
            "wall_s": wall,
            "rows_per_s": self.rows / wall if wall else 0.0,
            "interval_rows_per_s": (self.rows - self._prev_rows) / idt,
            "quantize_s": self.quantize_s,
            "score_s": self.score_s,
            # quantize overlaps score on the worker thread, so the
            # fractions describe where the work went, not wall time
            "quantize_frac": self.quantize_s / busy if busy else 0.0,
            "chunk_p50_ms": self._chunk_lat.percentile(50) * 1e3,
            "chunk_p99_ms": self._chunk_lat.percentile(99) * 1e3,
            "pad_overhead": (self.padded_rows / pad_total
                             if pad_total else 0.0),
        }
        if advance_interval:
            self._prev_t = now
            self._prev_rows = self.rows
        return snap

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return self._locked_snapshot(advance_interval=True)

    @staticmethod
    def merge(parts: list["ScoringMetrics"]) -> dict[str, Any]:
        """One fleet view over per-shard or per-worker bulk metrics, as
        `ServerMetrics.merge`: counts, first calls and the rates sum (K
        workers at X rows/s move K*X rows/s), wall is the slowest part's
        (the parts run concurrently), and the chunk-latency percentiles
        come from the merged reservoirs, not averaged per part."""
        if not parts:
            raise ValueError("ScoringMetrics.merge needs at least one "
                             "part")
        # one locked pass a part: its snapshot and its reservoir come
        # from the same instant, and the non-advancing read leaves each
        # part's interval window to its own poller
        snaps = []
        lat = PercentileReservoir()
        pad_rows = rows = 0
        for p in parts:
            with p._lock:
                snaps.append(p._locked_snapshot(advance_interval=False))
                lat.merge(p._chunk_lat)
                pad_rows += p.padded_rows
                rows += p.rows
        quantize_s = sum(s["quantize_s"] for s in snaps)
        score_s = sum(s["score_s"] for s in snaps)
        busy = quantize_s + score_s
        pad_total = rows + pad_rows
        return {
            "name": snaps[0]["name"],
            "parts": len(parts),
            "rows": rows,
            "chunks": sum(s["chunks"] for s in snaps),
            "compiles": sum(s["compiles"] for s in snaps),
            "resumed_from": min(s["resumed_from"] for s in snaps),
            "wall_s": max(s["wall_s"] for s in snaps),
            "rows_per_s": sum(s["rows_per_s"] for s in snaps),
            "interval_rows_per_s": sum(s["interval_rows_per_s"]
                                       for s in snaps),
            "quantize_s": quantize_s,
            "score_s": score_s,
            "quantize_frac": quantize_s / busy if busy else 0.0,
            "chunk_p50_ms": lat.percentile(50) * 1e3,
            "chunk_p99_ms": lat.percentile(99) * 1e3,
            "pad_overhead": (pad_rows / pad_total if pad_total else 0.0),
        }

    def __repr__(self) -> str:
        s = self.snapshot()
        return (f"<ScoringMetrics {s['name']}: {s['rows']} rows in "
                f"{s['chunks']} chunks, {s['rows_per_s']:.0f} rows/s, "
                f"quantize {s['quantize_frac']:.0%} of busy time>")


@dataclasses.dataclass(frozen=True)
class ChunkSpan:
    """One planned chunk: rows [start, stop) padded up to `padded`."""
    index: int
    start: int
    stop: int
    padded: int

    @property
    def n_valid(self) -> int:
        return self.stop - self.start


def plan_chunks(n_rows: int, chunk_rows: int) -> tuple[ChunkSpan, ...]:
    """Cut n_rows into fixed `chunk_rows` spans; the tail span is padded
    to the smallest power-of-two bucket holding it (so a run is at most 2
    distinct padded shapes: the chunk and one tail bucket)."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    ladder = pow2_buckets(chunk_rows, min_bucket=min(16, chunk_rows))
    spans = []
    for i, start in enumerate(range(0, n_rows, chunk_rows)):
        stop = min(start + chunk_rows, n_rows)
        n = stop - start
        padded = chunk_rows if n == chunk_rows else bucket_for(n, ladder)
        spans.append(ChunkSpan(i, start, stop, padded))
    return tuple(spans)


@dataclasses.dataclass(frozen=True)
class ScoreResult:
    """What a bulk run produced: per-model sink results, the metrics
    snapshot, and the shape-contract evidence (`chunk_shapes` is the set
    of padded shapes the plans saw: always <= 2)."""
    outputs: dict[str, Any]
    metrics: dict[str, Any]
    chunk_rows: int
    chunk_shapes: tuple[int, ...]
    n_rows: int

    @property
    def output(self) -> Any:
        """Single-model convenience accessor."""
        if len(self.outputs) != 1:
            raise ValueError(f"run scored {sorted(self.outputs)}; pick "
                             "one from .outputs")
        return next(iter(self.outputs.values()))


@dataclasses.dataclass
class _SchemaGroup:
    """Plans sharing one quantization schema: quantized once a chunk by
    the representative plan `rep`, always at the full chunk shape (its
    `quantize` entry sees one shape a run); the tail's pool is sliced and
    bucket-padded after."""
    fingerprint: str
    use_pool: bool
    rep: Predictor
    names: list[str]


class _ChunkIO:
    """Host <-> card traffic of one run: the pinned input buffer the
    worker fills, its side stream, and the ring of pinned output buffers
    the main thread copies scores into.  On the CPU there is no stream
    and no pinned buffer: `to_device` only pads, the rest do nothing."""

    def __init__(self, device: torch.device, rows: int, n_features: int):
        self.device = device
        self.rows = rows
        self.cuda = device.type == "cuda"
        self._slot = 0
        self._out: dict[tuple[str, int], torch.Tensor] = {}
        if self.cuda:
            self.side = torch.cuda.Stream(device)
            self._pinned = torch.empty((rows, n_features),
                                       dtype=torch.float32, pin_memory=True)

    # -- the worker thread ---------------------------------------------------
    def side_stream(self):
        return torch.cuda.stream(self.side) if self.cuda \
            else contextlib.nullcontext()

    def to_device(self, x: np.ndarray, rows: int) -> torch.Tensor:
        """(rows, F) float32 on the device: `x` zero-padded to `rows`.  On
        the card, an asynchronous copy from the pinned buffer on the side
        stream (call inside `side_stream()`, then `finish`)."""
        n = x.shape[0]
        if not self.cuda:
            out = torch.zeros((rows, x.shape[1]), dtype=torch.float32)
            out[:n] = torch.from_numpy(x)
            return out
        host = self._pinned[:rows]
        host.numpy()[:n] = x
        host[n:].zero_()
        return host.to(self.device, non_blocking=True)

    def finish(self) -> Optional[torch.cuda.Event]:
        """Record the side stream's work and wait for it on this thread:
        the pinned buffer may be refilled after this."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(self.side)
        event.synchronize()
        return event

    # -- the main thread -----------------------------------------------------
    def receive(self, payload: dict[str, Any],
                event: Optional[torch.cuda.Event]) -> None:
        """Order the main stream after the worker's event, and tell the
        allocator the main stream uses the tensors that crossed over."""
        if not self.cuda:
            return
        main = torch.cuda.current_stream(self.device)
        main.wait_event(event)
        for value in payload.values():
            t = value.bins if isinstance(value, QuantizedPool) else value
            t.record_stream(main)

    def to_host(self, name: str, out: torch.Tensor) -> torch.Tensor:
        """Start copying one plan's scores to a pinned host buffer (a ring
        of two a plan: the lag-1 drain waits for a copy before the buffer
        comes round again)."""
        if not self.cuda:
            return out
        key = (name, self._slot)
        buf = self._out.get(key)
        if buf is None or buf.dtype != out.dtype \
                or buf.shape[1:] != out.shape[1:]:
            buf = torch.empty((self.rows,) + tuple(out.shape[1:]),
                              dtype=out.dtype, pin_memory=True)
            self._out[key] = buf
        host = buf[:out.shape[0]]
        host.copy_(out, non_blocking=True)
        return host

    def copied(self) -> Optional[torch.cuda.Event]:
        """Mark the end of one chunk's copies on the main stream."""
        self._slot ^= 1
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event


class BulkScorer:
    """Apply one or many `Predictor` plans to a `RowSource`, streaming
    scores into `ScoreSink`s (see the module docstring).

    Pass a single plan or a ``{name: Predictor}`` mapping; all plans must
    agree on feature count and device (they read the same source, and the
    run is on their device).  The scorer keeps no state across runs, so
    `score` may be called repeatedly.
    """

    def __init__(self, plans: Predictor | Mapping[str, Predictor],
                 config: Optional[ScoreConfig] = None, *,
                 mesh=None, **config_kw: Any):
        if config is None:
            config = ScoreConfig(**config_kw)
        elif config_kw:
            raise TypeError("pass either a ScoreConfig or config kwargs, "
                            f"not both: {sorted(config_kw)}")
        self.config = config
        # every chunk's rows shard over the mesh through the plans'
        # `sharded()` entries (see the module docstring)
        self.mesh = mesh
        if isinstance(plans, Predictor):
            plans = {"model": plans}
        self.plans = dict(plans)
        if not self.plans:
            raise ValueError("BulkScorer needs at least one plan")
        for name, plan in self.plans.items():
            if not isinstance(plan, Predictor):
                raise TypeError(f"plans[{name!r}] is {type(plan).__name__},"
                                " not a Predictor (build one with "
                                "Predictor.build)")
        feats = {p.ensemble.n_features for p in self.plans.values()}
        if len(feats) > 1:
            raise ValueError(f"plans disagree on feature count {feats}; "
                             "one source feeds them all")
        self.n_features = feats.pop()
        devices = {p.device for p in self.plans.values()}
        if len(devices) > 1:
            raise ValueError(f"plans on several devices {devices}; one "
                             "run scores on one device")
        self.device = devices.pop()
        # quantize once per schema fingerprint, score every plan in the
        # group from that pool (the predict_multi pattern, offline)
        self._groups: dict[str, _SchemaGroup] = {}
        for name, plan in self.plans.items():
            fp = plan.schema_fingerprint
            g = self._groups.get(fp)
            if g is None:
                can_pool = (config.prequantize and
                            plan.ensemble.borders.shape[0] <= MAX_BINS - 1)
                g = _SchemaGroup(fp, can_pool, plan, [])
                self._groups[fp] = g
            g.names.append(name)
        self._group_of = {name: g for g in self._groups.values()
                          for name in g.names}

    # -- planning ----------------------------------------------------------
    def resolve_chunk_rows(self, n_rows: int) -> int:
        if self.config.chunk_rows:
            return self.config.chunk_rows
        ensembles = [p.ensemble for p in self.plans.values()]
        return tuning.best_chunk_rows(
            self.n_features, max(e.n_outputs for e in ensembles),
            n_trees=max(e.n_trees for e in ensembles),
            budget_bytes=self.config.chunk_budget_bytes, n_rows=n_rows)

    def _output_width(self, plan: Predictor) -> int:
        c = plan.ensemble.n_outputs
        if self.config.output == "raw":
            return c
        if self.config.output == "proba":
            return max(c, 2)
        return 1                                    # classify

    # -- the run -----------------------------------------------------------
    def _prepare(self, metrics: ScoringMetrics, io: _ChunkIO,
                 chunk_rows: int):
        """The prefetch transform: move a chunk to the device and binarize
        it once per schema group.  Runs on the Prefetcher worker thread,
        so chunk k+1 is read and quantized while chunk k scores, or inline
        on the main thread when the run has no worker."""
        need_float = any(not g.use_pool for g in self._groups.values())
        pools = [g for g in self._groups.values() if g.use_pool]

        def prepare(item):
            span, x = item
            t0 = time.perf_counter()
            payload: dict[str, Any] = {}
            # on the Prefetcher worker this span lands on its thread's
            # track, so chunk k+1's quantize shows under chunk k's
            # bulk/score on the main thread's
            with _TRACER.span("bulk/quantize", "bulk", chunk=span.index,
                              rows=span.n_valid, padded=span.padded), \
                    io.side_stream():
                # the pools quantize at the full chunk shape, the float
                # route scores at the span's padded shape (past the chunk
                # for the tail of a chunk that is not a power of two)
                x_dev = io.to_device(x, max(chunk_rows, span.padded)
                                     if pools else span.padded)
                if need_float:
                    payload[_FLOAT] = x_dev[:span.padded]
                for g in pools:
                    pool = g.rep.quantize(x_dev[:chunk_rows])
                    if span.padded != chunk_rows:
                        # tail: slice the valid rows back out and
                        # bucket-pad the pool to the planned tail shape
                        pool = pool.slice_rows(0, span.n_valid) \
                                   .pad_rows(span.padded)
                    payload[g.fingerprint] = pool
                event = io.finish()
            metrics.note_quantize(time.perf_counter() - t0)
            return span, payload, event
        return prepare

    def _score_entry(self, plan: Predictor, x) -> torch.Tensor:
        out = self.config.output
        if self.mesh is not None:
            raw = plan.sharded(self.mesh)(x).to(plan.device)
            if out == "raw":
                return raw
            if out == "proba":
                return proba_from_raw(raw, plan.ensemble.n_outputs)
            return classify_from_raw(raw, plan.ensemble.n_outputs)
        if out == "raw":
            return plan.raw(x)
        if out == "proba":
            return plan.proba(x)
        return plan.classify(x)

    def score(self, source: RowSource, sinks=None, *,
              resume_from: int = 0) -> ScoreResult:
        """Stream the whole source through every plan.

        `sinks` is a ``{name: ScoreSink}`` mapping, a single sink (for
        single-plan scorers), or None (a fresh `ArraySink` per plan: the
        whole output in host memory; pass `NpySink`s to stay out of
        core).  ``resume_from=k`` skips chunks < k: chunk boundaries
        depend only on (n_rows, chunk_rows), so a resumed run lands its
        rows at identical positions; pair it with row-addressed sinks
        (`NpySink(resume=True)`), the streaming reducers fold only the
        remaining rows.
        """
        if source.n_features != self.n_features:
            raise ValueError(f"source has {source.n_features} features, "
                             f"plans expect {self.n_features}")
        n_rows = source.n_rows
        chunk_rows = self.resolve_chunk_rows(n_rows)
        spans = plan_chunks(n_rows, chunk_rows)
        if not 0 <= resume_from <= len(spans):
            raise ValueError(f"resume_from={resume_from} outside "
                             f"[0, {len(spans)}] for {len(spans)} chunks "
                             f"of {chunk_rows} rows")
        todo = spans[resume_from:]

        sinks = self._normalize_sinks(sinks)
        for name, plan in self.plans.items():
            sinks[name].open(n_rows, self._output_width(plan))

        metrics = ScoringMetrics()
        metrics.resumed_from = resume_from
        traces0 = sum(p.stats["total_traces"] for p in self.plans.values())
        metrics.start()

        def read_spans():
            for span in todo:
                yield span, np.asarray(source.read(span.start, span.stop),
                                       np.float32)

        io = _ChunkIO(self.device, max(chunk_rows,
                                       max(s.padded for s in todo)),
                      self.n_features) if todo else None
        metrics.prefetch_depth = tuning.prefetch_depth(
            self.config.prefetch_depth, chunk_rows, len(todo),
            self.device.type == "cuda")
        if todo:
            prepare = self._prepare(metrics, io, chunk_rows)
            if metrics.prefetch_depth:
                stream = Prefetcher(read_spans(),
                                    depth=metrics.prefetch_depth,
                                    transform=prepare)
            else:
                stream = map(prepare, read_spans())
        else:
            stream = iter(())

        def drain(entry):
            span, outs, copied, t0 = entry
            with _TRACER.span("bulk/sink", "bulk", chunk=span.index,
                              rows=span.n_valid):
                if copied is not None:
                    copied.synchronize()              # host sync point
                for name, ys in outs.items():
                    ys = np.array(ys.numpy()[:span.n_valid], np.float32)
                    if ys.ndim == 1:                  # classify: (N,) ids
                        ys = ys[:, None]
                    sinks[name].write(span.start, ys)
            metrics.note_chunk(span.n_valid, span.padded,
                               time.perf_counter() - t0)

        # lag-1 drain: chunk k+1's kernels are launched before the host
        # waits for chunk k's scores, so the card stays busy while the
        # host writes sinks (pending holds at most 2 chunks: the O(chunk)
        # memory contract includes it)
        pending: list = []
        try:
            for span, payload, event in stream:
                t0 = time.perf_counter()
                io.receive(payload, event)
                outs = {}
                # covers the launches only (the card runs on): the wait
                # for the scores is under the chunk's bulk/sink span
                with _TRACER.span("bulk/score", "bulk", device=self.device,
                                  chunk=span.index, rows=span.n_valid,
                                  padded=span.padded,
                                  models=len(self.plans)):
                    for name, plan in self.plans.items():
                        g = self._group_of[name]
                        x_in = payload[g.fingerprint if g.use_pool
                                       else _FLOAT]
                        outs[name] = io.to_host(
                            name, self._score_entry(plan, x_in))
                pending.append((span, outs, io.copied(), t0))
                if len(pending) > 1:
                    drain(pending.pop(0))
            while pending:
                drain(pending.pop(0))
        finally:
            if isinstance(stream, Prefetcher):
                stream.close()
        metrics.stop()
        metrics.compiles = sum(p.stats["total_traces"]
                               for p in self.plans.values()) - traces0

        outputs = {name: sinks[name].close() for name in self.plans}
        return ScoreResult(outputs=outputs, metrics=metrics.snapshot(),
                           chunk_rows=chunk_rows,
                           chunk_shapes=tuple(sorted(
                               {s.padded for s in todo})),
                           n_rows=n_rows)

    def _normalize_sinks(self, sinks) -> dict[str, ScoreSink]:
        if sinks is None:
            return {name: ArraySink() for name in self.plans}
        if isinstance(sinks, Mapping):
            missing = set(self.plans) - set(sinks)
            if missing:
                raise ValueError(f"no sink for plans {sorted(missing)}")
            return {name: sinks[name] for name in self.plans}
        if len(self.plans) != 1:
            raise ValueError("a single bare sink needs a single plan; "
                             f"got plans {sorted(self.plans)}")
        return {next(iter(self.plans)): sinks}
