"""Score sinks: where the bulk scorer streams its output.

The port's copy of `src/repro/scoring/sinks.py` (numpy only).

A `ScoreSink` receives row-addressed score panels and never requires
the whole output in memory at once:

    sink.open(n_rows, n_cols)       # called once, total output shape
    sink.write(start, scores)       # (n, n_cols) float32 rows at `start`
    result = sink.close()           # sink-specific result value

``write`` is row-addressed (not append-only) so a resumed run
(`BulkScorer.score(..., resume_from=k)`) can drop its chunks into the
same positions — `ArraySink` and `NpySink` are idempotent per row range
and safe to resume into; the streaming reducers (`StatsSink`,
`TopKSink`) fold rows as they pass and must see every chunk exactly
once, so resume into a *fresh* reducer only scores the remaining rows.

`NpySink` is the out-of-core output: a ``.npy`` memmap the OS pages
out, so a dataset-sized score matrix costs O(chunk) host memory — the
mirror image of `sources.NpyMemmapSource`.
"""
from __future__ import annotations

import pathlib
from typing import Any, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class ScoreSink(Protocol):
    """Row-addressed streaming score consumer (see module docstring)."""

    def open(self, n_rows: int, n_cols: int) -> None: ...

    def write(self, start: int, scores: np.ndarray) -> None: ...

    def close(self) -> Any: ...


class _SinkBase:
    """Shared open/write bookkeeping: shape checks + rows_written."""

    def __init__(self):
        self.n_rows = self.n_cols = -1
        self.rows_written = 0

    def open(self, n_rows: int, n_cols: int) -> None:
        if n_rows < 0 or n_cols < 1:
            raise ValueError(f"bad sink shape ({n_rows}, {n_cols})")
        self.n_rows, self.n_cols = n_rows, n_cols
        self.rows_written = 0

    def _check_write(self, start: int, scores: np.ndarray) -> np.ndarray:
        if self.n_rows < 0:
            raise ValueError("sink.write before sink.open")
        scores = np.asarray(scores, np.float32)
        if scores.ndim != 2 or scores.shape[1] != self.n_cols:
            raise ValueError(f"scores shape {scores.shape} does not match "
                             f"sink width {self.n_cols}")
        if not 0 <= start <= start + scores.shape[0] <= self.n_rows:
            raise ValueError(f"write span [{start}, "
                             f"{start + scores.shape[0]}) outside "
                             f"[0, {self.n_rows})")
        self.rows_written += scores.shape[0]
        return scores


class ArraySink(_SinkBase):
    """Scores into one in-memory float32 array; `close` returns it."""

    def __init__(self):
        super().__init__()
        self.scores: np.ndarray | None = None

    def open(self, n_rows: int, n_cols: int) -> None:
        super().open(n_rows, n_cols)
        self.scores = np.zeros((n_rows, n_cols), np.float32)

    def write(self, start: int, scores: np.ndarray) -> None:
        scores = self._check_write(start, scores)
        self.scores[start:start + scores.shape[0]] = scores

    def close(self) -> np.ndarray:
        return self.scores


class NpySink(_SinkBase):
    """Scores into a ``.npy`` memmap on disk; `close` flushes and
    returns the path.

    ``resume=True`` reopens an existing file in place (shape must
    match) instead of truncating it — the resume-by-chunk-index
    contract: rows written by the interrupted run survive, the resumed
    run fills in the rest.
    """

    def __init__(self, path: str | pathlib.Path, *, resume: bool = False):
        super().__init__()
        self.path = pathlib.Path(path)
        self.resume = resume
        self._mm: np.memmap | None = None

    def open(self, n_rows: int, n_cols: int) -> None:
        super().open(n_rows, n_cols)
        if self.resume and self.path.exists():
            mm = np.lib.format.open_memmap(self.path, mode="r+")
            if mm.shape != (n_rows, n_cols) or mm.dtype != np.float32:
                raise ValueError(
                    f"{self.path}: existing file is {mm.dtype}"
                    f"{mm.shape}, cannot resume a float32"
                    f"{(n_rows, n_cols)} run into it")
            self._mm = mm
        else:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._mm = np.lib.format.open_memmap(
                self.path, mode="w+", dtype=np.float32,
                shape=(n_rows, n_cols))

    def write(self, start: int, scores: np.ndarray) -> None:
        scores = self._check_write(start, scores)
        self._mm[start:start + scores.shape[0]] = scores

    def close(self) -> pathlib.Path:
        if self._mm is not None:
            self._mm.flush()
            self._mm = None
        return self.path


class StatsSink(_SinkBase):
    """Streaming per-column moments: count / mean / std / min / max.

    Chan's parallel-variance merge per chunk, so the reduction is
    one pass, O(n_cols) state, and independent of chunk order — the
    score-distribution monitor for a nightly rescore (drift alarms
    compare these against the previous run's).  `close` returns the
    stats dict.
    """

    def __init__(self):
        super().__init__()
        self._count = 0
        self._mean: np.ndarray | None = None
        self._m2: np.ndarray | None = None
        self._min: np.ndarray | None = None
        self._max: np.ndarray | None = None

    def open(self, n_rows: int, n_cols: int) -> None:
        super().open(n_rows, n_cols)
        self._count = 0
        self._mean = np.zeros(n_cols, np.float64)
        self._m2 = np.zeros(n_cols, np.float64)
        self._min = np.full(n_cols, np.inf, np.float64)
        self._max = np.full(n_cols, -np.inf, np.float64)

    def write(self, start: int, scores: np.ndarray) -> None:
        scores = self._check_write(start, scores)
        n = scores.shape[0]
        if n == 0:
            return
        s = scores.astype(np.float64)
        mean_b = s.mean(axis=0)
        m2_b = ((s - mean_b) ** 2).sum(axis=0)
        if self._count == 0:
            self._mean, self._m2 = mean_b, m2_b
        else:
            delta = mean_b - self._mean
            tot = self._count + n
            self._mean = self._mean + delta * (n / tot)
            self._m2 = self._m2 + m2_b + delta ** 2 * (self._count * n / tot)
        self._count += n
        np.minimum(self._min, s.min(axis=0), out=self._min)
        np.maximum(self._max, s.max(axis=0), out=self._max)

    def close(self) -> dict[str, Any]:
        var = (self._m2 / self._count if self._count
               else np.zeros_like(self._m2))
        return {
            "count": self._count,
            "mean": np.asarray(self._mean),
            "std": np.sqrt(var),
            "min": np.asarray(self._min),
            "max": np.asarray(self._max),
        }


class TopKSink(_SinkBase):
    """Streaming top-k rows by one score column.

    Keeps the k best (row index, full score row) seen so far by merging
    each chunk against the running top set — O(k + chunk) per write, so
    "give me the 100 highest-risk customers of 50M" never ranks the
    full output.  `close` returns ``{"indices", "scores"}`` sorted
    best-first.  ``largest=False`` flips to bottom-k.
    """

    def __init__(self, k: int, *, column: int = 0, largest: bool = True):
        super().__init__()
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k
        self.column = column
        self.largest = largest
        self._idx: np.ndarray | None = None
        self._rows: np.ndarray | None = None

    def open(self, n_rows: int, n_cols: int) -> None:
        super().open(n_rows, n_cols)
        if not -n_cols <= self.column < n_cols:
            raise ValueError(f"column {self.column} outside the "
                             f"{n_cols}-wide score row")
        self._idx = np.zeros(0, np.int64)
        self._rows = np.zeros((0, n_cols), np.float32)

    def write(self, start: int, scores: np.ndarray) -> None:
        scores = self._check_write(start, scores)
        if scores.shape[0] == 0:
            return
        idx = np.concatenate([
            self._idx, np.arange(start, start + scores.shape[0])])
        rows = np.concatenate([self._rows, scores], axis=0)
        key = rows[:, self.column]
        if not self.largest:
            key = -key
        keep = np.argsort(-key, kind="stable")[:self.k]
        self._idx, self._rows = idx[keep], rows[keep]

    def close(self) -> dict[str, np.ndarray]:
        return {"indices": self._idx, "scores": self._rows}
