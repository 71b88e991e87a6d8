"""Host-side batching and background prefetch: the port's counterpart of
`src/repro/data/pipeline.py`.

`BatchIterator` (shuffled epochs over array dicts) and `TokenSource` (the
synthetic LM token stream the trainer, its launcher and example train on)
are the JAX package's numpy code, so their batches equal JAX's array for
array; a real deployment would swap `TokenSource` for a file-backed
loader with the same interface (`__iter__` yielding dict batches).
`shard_batch` places a batch onto a mesh as DTensors, one process a
shard (`distributed.runtime`).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np


class BatchIterator:
    """Shuffled epoch iterator over array dicts."""

    def __init__(self, arrays: dict[str, np.ndarray], batch_size: int, *,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        self.arrays = arrays
        self.n = next(iter(arrays.values())).shape[0]
        for v in arrays.values():
            if v.shape[0] != self.n:
                raise ValueError("ragged arrays")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_remainder = drop_remainder

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        order = (self.rng.permutation(self.n) if self.shuffle
                 else np.arange(self.n))
        stop = (self.n - self.n % self.batch_size if self.drop_remainder
                else self.n)
        for s in range(0, stop, self.batch_size):
            sel = order[s:s + self.batch_size]
            yield {k: v[sel] for k, v in self.arrays.items()}


class TokenSource:
    """Synthetic LM token stream: (tokens, labels) with next-token labels.

    `next_batch(step)` depends on `step` alone, so a resumed run replays
    the stream from any step."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def next_batch(self, step: int | None = None) -> dict[str, np.ndarray]:
        rng = (np.random.default_rng(step) if step is not None else self.rng)
        # Markov-ish stream so a model can actually reduce loss.
        base = rng.integers(0, self.vocab_size,
                            size=(self.batch_size, self.seq_len + 1))
        base[:, 1::2] = (base[:, 0::2][:, :base[:, 1::2].shape[1]]
                         + 1) % self.vocab_size
        return {"tokens": base[:, :-1].astype(np.int32),
                "labels": base[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.next_batch(step)
            step += 1


# How long `close` waits for the worker to finish the item in hand.
CLOSE_TIMEOUT_S = 60.0


def shard_batch(batch: dict, mesh, spec=None) -> dict:
    """JAX's `shard_batch`: each array of `batch` as a DTensor on `mesh`
    by `spec` (default ``P(("data",))``: the leading dim over "data"),
    fitted to its shape (an axis that does not divide a dim leaves it
    whole).  Every rank holds the whole global batch, as JAX's host does,
    and keeps its own slice of it: no collective."""
    from repro_torch.distributed import sharding as shd

    spec = shd.P(("data",)) if spec is None else spec
    return {k: shd.place(v, mesh, spec, src_data_rank=None)
            for k, v in batch.items()}


class Prefetcher:
    """A worker thread runs `transform` over `it` up to `depth` items ahead
    of the consumer.

    The queue bound is the backpressure: a slow consumer holds the worker
    at most `depth` items ahead.  An exception raised by `it` or
    `transform` on the worker reaches the consumer, after the items
    produced before it; it never ends the stream as if it were complete.
    `close` stops the worker and waits for it to leave.
    """

    def __init__(self, it: Iterator, *, depth: int = 2,
                 transform: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.transform = transform
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    if self.transform is not None:
                        item = self.transform(item)
                    self.q.put(item)
            except BaseException as e:      # noqa: BLE001 — re-raised below
                self._err = e
            finally:
                self.q.put(None)

        # named so a trace or a thread dump labels its track
        self.thread = threading.Thread(target=worker, daemon=True,
                                       name="prefetcher")
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                if self._err is not None:
                    err, self._err = self._err, None
                    raise err
                return
            yield item

    def close(self) -> None:
        """Stop the worker: drain the queue until it has left (it finishes
        the item in hand first), so no transform runs after `close`
        returns.  Raises if the worker is still busy after
        `CLOSE_TIMEOUT_S` seconds."""
        timeout = CLOSE_TIMEOUT_S
        self._stop.set()
        while self.thread.is_alive() and timeout > 0:
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                timeout -= 0.05
        self.thread.join(timeout=max(timeout, 0.0))
        if self.thread.is_alive():
            raise RuntimeError("the prefetch worker did not stop")
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
