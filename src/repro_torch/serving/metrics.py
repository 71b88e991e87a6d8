"""Per-model serving metrics: throughput, latency percentiles, recompiles.

The port's copy of `src/repro/serving/metrics.py` (numpy only).
Thread-safe counters + a bounded latency reservoir.  `note_trace()` is
called by the predict plan on the first call of each (entry, batch
shape), the port's counterpart of a jit trace, so `recompiles` counts
exactly the shapes the bucketing layer exists to bound.

Rates come in two flavours (both exported):

* lifetime — counter / seconds since construction (or `reset()`); the
  long-run average, but it decays toward zero on an idle server.
* interval — delta since the *previous* `snapshot()` call; what a
  poller should alert on.

Deadline SLO: give `ServerMetrics` a `deadline_ms` and every batch's
latency is classified hit/miss per valid row; `note_shed()` counts
requests rejected before scoring.  Snapshots then report
`deadline_attainment`, `shed_rate`, and `p99_under_deadline_ms` (p99
over the latencies that met the deadline).
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any

import numpy as np


class PercentileReservoir:
    """Bounded uniform sample of a value stream for percentile queries.

    Classic reservoir sampling: every value ever added has an equal
    chance of being in the sample, so a burst of slow warmup compiles
    cannot pin p99 forever the way a sliding window's eviction order
    would.  Not thread-safe on its own — callers (ServerMetrics) hold
    their own lock around `add`/`percentile`.
    """

    def __init__(self, max_samples: int = 8192, seed: int = 0):
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.max_samples = max_samples
        self._values: list[float] = []
        self._seen = 0
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        self._seen += 1
        if len(self._values) < self.max_samples:
            self._values.append(value)
        else:
            j = self._rng.randrange(self._seen)
            if j < self.max_samples:
                self._values[j] = value

    def percentile(self, q: float) -> float:
        """q-th percentile of the sample (0.0 when empty)."""
        if not self._values:
            return 0.0
        return float(np.percentile(np.asarray(self._values), q))

    def __len__(self) -> int:
        return len(self._values)

    @property
    def seen(self) -> int:
        """Total values ever added (>= len(self): the sample is bounded)."""
        return self._seen

    def merge(self, other: "PercentileReservoir") -> None:
        """Absorb another reservoir's sample into this one.

        Each side's sample is a uniform draw from its own stream;
        subsampling the concatenation proportionally to the stream
        sizes keeps the merged sample an (approximately) uniform draw
        from the combined stream — the fleet-view aggregation
        `ServerMetrics.merge` percentile
        queries run on.  `seen` adds exactly.
        """
        if not isinstance(other, PercentileReservoir):
            raise TypeError(f"cannot merge {type(other).__name__} into "
                            "PercentileReservoir")
        merged = self._values + other._values
        total = self._seen + other._seen
        if len(merged) > self.max_samples:
            # allocate the bounded sample across the two sides
            # proportionally to their *stream* sizes (not their sample
            # sizes), then uniform-subsample within each side
            n_self = min(round(self.max_samples * self._seen
                               / max(total, 1)), len(self._values))
            n_other = min(self.max_samples - n_self, len(other._values))
            n_self = min(self.max_samples - n_other, len(self._values))
            merged = (self._rng.sample(self._values, n_self)
                      + self._rng.sample(other._values, n_other))
        self._values = merged
        self._seen = total


class ServerMetrics:
    MAX_LAT_SAMPLES = 8192

    def __init__(self, name: str = "model",
                 deadline_ms: float | None = None):
        self.name = name
        # Physical model layout the server's plan lowered to (set by
        # GBDTServer once its Predictor is built; None until then).
        # Exported in snapshots so dashboards can see which layout a
        # deployed model is actually serving with.
        self.layout: str | None = None
        self.deadline_ms = deadline_ms
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.requests = 0
        self.batches = 0
        self.padded_rows = 0
        self.served_rows = 0
        self.traces = 0
        self.deadline_hits = 0
        self.deadline_misses = 0
        self.shed_requests = 0
        self._lat = PercentileReservoir(self.MAX_LAT_SAMPLES)
        # latencies restricted to batches that met the deadline; the
        # tail of *served-within-SLO* traffic (p99_under_deadline_ms)
        self._lat_ok = PercentileReservoir(self.MAX_LAT_SAMPLES)
        # interval-rate markers: state of the previous snapshot() call
        self._prev_t = self._t0
        self._prev_requests = 0
        self._prev_rows = 0

    # -- recording ---------------------------------------------------------
    def note_trace(self) -> None:
        """Called by the plan on the first call of each (entry, shape)."""
        with self._lock:
            self.traces += 1

    def note_batch(self, n_valid: int, n_padded: int,
                   latency_s: float) -> None:
        with self._lock:
            self.batches += 1
            self.requests += n_valid
            self.served_rows += n_valid
            self.padded_rows += n_padded - n_valid
            self._lat.add(latency_s)
            if self.deadline_ms is not None:
                if latency_s * 1e3 <= self.deadline_ms:
                    self.deadline_hits += n_valid
                    self._lat_ok.add(latency_s)
                else:
                    self.deadline_misses += n_valid

    def note_shed(self, n: int = 1) -> None:
        """Requests rejected before scoring (queue full / deadline
        already blown on arrival).  Sheds never enter the latency
        reservoir — they were not served."""
        with self._lock:
            self.shed_requests += n

    def reset(self) -> None:
        """Zero all counters and restart both rate clocks.  The model
        name / layout / deadline configuration survive."""
        with self._lock:
            self._t0 = time.perf_counter()
            self.requests = self.batches = 0
            self.padded_rows = self.served_rows = self.traces = 0
            self.deadline_hits = self.deadline_misses = 0
            self.shed_requests = 0
            self._lat = PercentileReservoir(self.MAX_LAT_SAMPLES)
            self._lat_ok = PercentileReservoir(self.MAX_LAT_SAMPLES)
            self._prev_t = self._t0
            self._prev_requests = self._prev_rows = 0

    # -- reporting ---------------------------------------------------------
    def _locked_snapshot(self, advance_interval: bool) -> dict[str, Any]:
        """Build the snapshot dict; caller holds self._lock.

        `advance_interval=False` leaves the interval markers untouched
        so a read (e.g. inside `merge`) does not consume another
        poller's interval window."""
        now = time.perf_counter()
        dt = max(now - self._t0, 1e-9)
        idt = max(now - self._prev_t, 1e-9)
        pad_total = self.served_rows + self.padded_rows
        slo_total = self.deadline_hits + self.deadline_misses
        offered = self.requests + self.shed_requests
        snap = {
            "model": self.name,
            "layout": self.layout,
            "requests": self.requests,
            "batches": self.batches,
            "recompiles": self.traces,
            "requests_per_s": self.requests / dt,
            # same unit the offline ScoringMetrics reports, so the
            # online and bulk dashboards are directly comparable
            # (for a server, every served row was a request row)
            "rows_per_s": self.served_rows / dt,
            "interval_requests_per_s":
                (self.requests - self._prev_requests) / idt,
            "interval_rows_per_s":
                (self.served_rows - self._prev_rows) / idt,
            "batch_p50_ms": self._lat.percentile(50) * 1e3,
            "batch_p99_ms": self._lat.percentile(99) * 1e3,
            "pad_overhead": (self.padded_rows / pad_total
                             if pad_total else 0.0),
            "deadline_ms": self.deadline_ms,
            "deadline_hits": self.deadline_hits,
            "deadline_misses": self.deadline_misses,
            # no SLO traffic yet -> vacuously attained, nothing shed
            "deadline_attainment": (self.deadline_hits / slo_total
                                    if slo_total else 1.0),
            "shed_requests": self.shed_requests,
            "shed_rate": (self.shed_requests / offered
                          if offered else 0.0),
            "p99_under_deadline_ms": self._lat_ok.percentile(99) * 1e3,
        }
        if advance_interval:
            self._prev_t = now
            self._prev_requests = self.requests
            self._prev_rows = self.served_rows
        return snap

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return self._locked_snapshot(advance_interval=True)

    @staticmethod
    def merge(parts: list["ServerMetrics"]) -> dict[str, Any]:
        """One fleet view over per-shard/per-replica metrics.

        Count-like fields (requests, batches, recompiles, SLO counters)
        and the throughput rates sum — R replicas each serving X rows/s
        really do serve R*X fleet rows/s — while the latency
        percentiles come from the *merged* reservoirs (a request on any
        replica is one draw from the fleet's latency distribution;
        averaging per-shard p99s would be wrong).  Layout is reported
        when every part agrees, else "mixed".

        Everything for a part — its snapshot fields AND its reservoir —
        is gathered in one locked pass, so counts and percentiles come
        from the same instant even under concurrent `note_batch` load.
        """
        if not parts:
            raise ValueError("ServerMetrics.merge needs at least one part")
        lat = PercentileReservoir(ServerMetrics.MAX_LAT_SAMPLES)
        lat_ok = PercentileReservoir(ServerMetrics.MAX_LAT_SAMPLES)
        snaps: list[dict[str, Any]] = []
        pad_rows = served = 0
        for p in parts:
            with p._lock:
                # non-advancing read: merge must not eat the interval
                # window a dashboard poller is accumulating per part
                snaps.append(p._locked_snapshot(advance_interval=False))
                lat.merge(p._lat)
                lat_ok.merge(p._lat_ok)
                pad_rows += p.padded_rows
                served += p.served_rows
        layouts = {s["layout"] for s in snaps}
        deadlines = {s["deadline_ms"] for s in snaps}
        pad_total = served + pad_rows
        hits = sum(s["deadline_hits"] for s in snaps)
        misses = sum(s["deadline_misses"] for s in snaps)
        shed = sum(s["shed_requests"] for s in snaps)
        requests = sum(s["requests"] for s in snaps)
        offered = requests + shed
        return {
            "model": snaps[0]["model"],
            "replicas": len(parts),
            "layout": layouts.pop() if len(layouts) == 1 else "mixed",
            "requests": requests,
            "batches": sum(s["batches"] for s in snaps),
            "recompiles": sum(s["recompiles"] for s in snaps),
            "requests_per_s": sum(s["requests_per_s"] for s in snaps),
            "rows_per_s": sum(s["rows_per_s"] for s in snaps),
            "interval_requests_per_s":
                sum(s["interval_requests_per_s"] for s in snaps),
            "interval_rows_per_s":
                sum(s["interval_rows_per_s"] for s in snaps),
            "batch_p50_ms": lat.percentile(50) * 1e3,
            "batch_p99_ms": lat.percentile(99) * 1e3,
            "pad_overhead": (pad_rows / pad_total if pad_total else 0.0),
            "deadline_ms": (deadlines.pop() if len(deadlines) == 1
                            else None),
            "deadline_hits": hits,
            "deadline_misses": misses,
            "deadline_attainment": (hits / (hits + misses)
                                    if hits + misses else 1.0),
            "shed_requests": shed,
            "shed_rate": shed / offered if offered else 0.0,
            "p99_under_deadline_ms": lat_ok.percentile(99) * 1e3,
        }

    def __repr__(self) -> str:
        s = self.snapshot()
        return (f"<ServerMetrics {s['model']}: {s['requests']} req "
                f"{s['requests_per_s']:.0f}/s recompiles={s['recompiles']} "
                f"p50={s['batch_p50_ms']:.1f}ms "
                f"p99={s['batch_p99_ms']:.1f}ms>")
