"""Request batching with bucketed padding.

The port's copy of `src/repro/serving/batching.py` (numpy only).  The
paper's speedups exist only for vector-width batches, so the server
aggregates requests (deadline-or-size, `Batcher`).  A deadline batcher
under real traffic emits a different batch size every flush;
`BucketedBatcher` zero-pads each flushed batch up to the smallest
configured bucket that holds it (powers of two up to ``max_batch`` by
default), so the predict plan only ever sees ``len(buckets)`` distinct
shapes and its first-call counter stays bounded by the bucket count.
Padded rows are sliced off before replies.
"""
from __future__ import annotations

import queue
import threading
import time
import dataclasses
from typing import Callable, Sequence

import numpy as np


# --------------------------------------------------------------------------
# Bucket utilities
# --------------------------------------------------------------------------
def pow2_buckets(max_batch: int, min_bucket: int = 16) -> tuple[int, ...]:
    """Power-of-two bucket ladder: (min_bucket, ..., >= max_batch).

    The top bucket is the first power of two >= max_batch, so any batch
    the Batcher can legally form has a home.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    b = 1
    while b < min_bucket:
        b *= 2
    out = [b]
    while out[-1] < max_batch:
        out.append(out[-1] * 2)
    return tuple(out)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (callers chunk anything above the top bucket)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    for b in sorted(buckets):
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds the largest bucket "
                     f"{max(buckets)}; chunk it first")


def chunks(n: int, size: int):
    """(start, stop) ranges cutting n rows into `size`-row chunks — the
    bulk paths (`predict_batch`, `predict_pool`) chunk oversized inputs
    at the largest bucket with this so they share the online path's
    compile cache."""
    if size < 1:
        raise ValueError(f"chunk size must be >= 1, got {size}")
    for start in range(0, n, size):
        yield start, min(start + size, n)


def pad_rows(xs: np.ndarray, target: int) -> np.ndarray:
    """Zero-pad axis 0 of xs up to target rows (no-op when equal)."""
    n = xs.shape[0]
    if n == target:
        return xs
    if n > target:
        raise ValueError(f"cannot pad {n} rows down to {target}")
    pad = np.zeros((target - n,) + xs.shape[1:], xs.dtype)
    return np.concatenate([xs, pad], axis=0)


# --------------------------------------------------------------------------
# Batchers
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    rid: int
    payload: np.ndarray
    future: "queue.Queue"


class Batcher:
    """Deadline-or-size request batching (max_batch or max_wait_ms)."""

    def __init__(self, serve_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 256, max_wait_ms: float = 2.0):
        self.serve_fn = serve_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.batch_sizes: list[int] = []
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _run_batch(self, xs: np.ndarray) -> np.ndarray:
        return np.asarray(self.serve_fn(xs))

    def _loop(self):
        while not self._stop.is_set():
            try:
                first: Request = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            xs = np.stack([r.payload for r in batch])
            self.batch_sizes.append(len(batch))
            ys = self._run_batch(xs)
            for r, y in zip(batch, ys):
                r.future.put(y)

    def submit(self, rid: int, payload: np.ndarray) -> "queue.Queue":
        fut: queue.Queue = queue.Queue(maxsize=1)
        self.q.put(Request(rid, payload, fut))
        return fut

    def close(self):
        self._stop.set()
        self.thread.join(timeout=2)


class BucketedBatcher(Batcher):
    """Batcher that pads each flushed batch to a size bucket before the
    serve_fn sees it, bounding JIT retraces by the bucket count."""

    def __init__(self, serve_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch: int = 256, max_wait_ms: float = 2.0,
                 buckets: Sequence[int] | None = None,
                 min_bucket: int = 16, metrics=None):
        self.buckets = tuple(sorted(buckets)) if buckets else \
            pow2_buckets(max_batch, min_bucket)
        if max_batch > self.buckets[-1]:
            raise ValueError(
                f"max_batch={max_batch} exceeds largest bucket "
                f"{self.buckets[-1]}")
        self.bucket_counts: dict[int, int] = {b: 0 for b in self.buckets}
        self.metrics = metrics            # ServerMetrics or None
        super().__init__(serve_fn, max_batch=max_batch,
                         max_wait_ms=max_wait_ms)

    def _run_batch(self, xs: np.ndarray) -> np.ndarray:
        n = xs.shape[0]
        bucket = bucket_for(n, self.buckets)
        self.bucket_counts[bucket] += 1
        t0 = time.perf_counter()
        ys = np.asarray(self.serve_fn(pad_rows(xs, bucket)))
        if self.metrics is not None:
            self.metrics.note_batch(n, bucket, time.perf_counter() - t0)
        return ys[:n]
