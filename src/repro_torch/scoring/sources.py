"""Row sources: how the bulk scorer reads datasets it cannot hold.

The port's copy of `src/repro/scoring/sources.py` (numpy only).

A `RowSource` is anything with ``n_rows``, ``n_features`` and
``read(start, stop) -> (stop-start, F) float32`` — random access by row
range, so the scorer can cut fixed-shape chunks and resume from any
chunk index without replaying the stream.  The contract is deliberately
a duck protocol, not a base class: a production loader (parquet shards,
a feature store scan) only has to answer range reads.

Peak host memory for every source here is O(read span), never
O(dataset): `NpyMemmapSource` pages rows in through the OS,
`SyntheticSource` tiles a small base dataset virtually to arbitrary row
counts (the out-of-core test rig — a 100M-row sweep costs the memory of
the base dataset plus one chunk).
"""
from __future__ import annotations

import pathlib
from typing import Iterator, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class RowSource(Protocol):
    """Range-readable float feature matrix (see module docstring)."""

    @property
    def n_rows(self) -> int: ...

    @property
    def n_features(self) -> int: ...

    def read(self, start: int, stop: int) -> np.ndarray: ...


def _check_span(source, start: int, stop: int) -> None:
    if not 0 <= start <= stop <= source.n_rows:
        raise ValueError(f"row span [{start}, {stop}) outside "
                         f"[0, {source.n_rows})")


def iter_chunks(source: RowSource, chunk_rows: int, *,
                start_row: int = 0) -> Iterator[np.ndarray]:
    """Plain chunk iterator over a source — the adapter the chunked
    quantize helpers (`quantize_pool_chunked`, `compute_borders_chunked`)
    consume."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    for s in range(start_row, source.n_rows, chunk_rows):
        yield source.read(s, min(s + chunk_rows, source.n_rows))


class ArraySource:
    """In-memory (or caller-managed memmap) feature matrix."""

    def __init__(self, x: np.ndarray):
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"ArraySource needs a (N, F) matrix, got "
                             f"shape {x.shape}")
        self._x = x

    @property
    def n_rows(self) -> int:
        return int(self._x.shape[0])

    @property
    def n_features(self) -> int:
        return int(self._x.shape[1])

    def read(self, start: int, stop: int) -> np.ndarray:
        _check_span(self, start, stop)
        return np.asarray(self._x[start:stop], np.float32)

    def __repr__(self) -> str:
        return f"<ArraySource {self.n_rows}x{self.n_features}>"


class NpyMemmapSource:
    """A ``.npy`` feature matrix paged in by the OS, never fully loaded.

    The on-disk dtype is served as float32 per chunk (`read` copies the
    requested span only).  Pair with `repro_torch.scoring.sinks.NpySink` for a
    disk-to-disk rescore whose host footprint is O(chunk).
    """

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self._x = np.load(self.path, mmap_mode="r")
        if self._x.ndim != 2:
            raise ValueError(f"{self.path}: expected a (N, F) matrix, got "
                             f"shape {self._x.shape}")

    @property
    def n_rows(self) -> int:
        return int(self._x.shape[0])

    @property
    def n_features(self) -> int:
        return int(self._x.shape[1])

    def read(self, start: int, stop: int) -> np.ndarray:
        _check_span(self, start, stop)
        # np.asarray on a memmap slice copies exactly the span read
        return np.asarray(self._x[start:stop], np.float32)

    def __repr__(self) -> str:
        return (f"<NpyMemmapSource {self.path.name} "
                f"{self.n_rows}x{self.n_features}>")


class SyntheticSource:
    """A `repro_torch.data.synthetic` dataset served as a scoring source,
    virtually tiled to out-of-core row counts.

    ``repeat=k`` serves the base split k times over (row i maps to base
    row ``i % base_rows``), so ``SyntheticSource("covertype", scale=0.1,
    repeat=20)`` is a ~280k-row sweep that costs the memory of the
    14k-row base — the rig the scoring benchmark and the paper's
    ApplyModelMulti-style dataset sweeps run on.  ``split`` picks which
    side of the train/test cut to serve ("test", "train" or "all").
    """

    def __init__(self, name: str, *, scale: float = 1.0,
                 seed: int | None = None, split: str = "test",
                 repeat: int = 1):
        from repro_torch.data import synthetic

        if repeat < 1:
            raise ValueError(f"repeat must be >= 1, got {repeat}")
        if split not in ("train", "test", "all"):
            raise ValueError(f"split must be train|test|all, got {split!r}")
        ds = synthetic.load(name, scale=scale, seed=seed)
        if split == "train":
            base = ds.x_train
        elif split == "test":
            base = ds.x_test
        else:
            base = np.concatenate([ds.x_train, ds.x_test], axis=0)
        if base.shape[0] == 0:
            raise ValueError(f"{name} at scale={scale} has no {split} rows")
        self.name = name
        self.dataset = ds
        self.repeat = repeat
        self._base = np.asarray(base, np.float32)

    @property
    def base_rows(self) -> int:
        return int(self._base.shape[0])

    @property
    def n_rows(self) -> int:
        return self.base_rows * self.repeat

    @property
    def n_features(self) -> int:
        return int(self._base.shape[1])

    def read(self, start: int, stop: int) -> np.ndarray:
        _check_span(self, start, stop)
        if stop - start == 0:
            return np.zeros((0, self.n_features), np.float32)
        idx = np.arange(start, stop) % self.base_rows
        return self._base[idx]

    def __repr__(self) -> str:
        return (f"<SyntheticSource {self.name} {self.n_rows}x"
                f"{self.n_features} (base {self.base_rows}, "
                f"repeat {self.repeat})>")
