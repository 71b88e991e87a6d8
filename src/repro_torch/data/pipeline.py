"""Background prefetch between a host-side item stream and its consumer.

The port's counterpart of `Prefetcher` in `src/repro/data/pipeline.py`.
`BatchIterator`, `TokenSource` and `shard_batch` belong to the LM scaffold
and are not ported yet (ROADMAP A11).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

# How long `close` waits for the worker to finish the item in hand.
CLOSE_TIMEOUT_S = 60.0


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
