"""Feature quantization: border computation and the `QuantizedPool` value
type the quantized-first evaluation API is built on.

The port's counterpart of `src/repro/core/quantize.py`.  `compute_borders`
runs the same numpy code as the JAX package, so both give bit-identical
borders; `borders_fingerprint` hashes the same bytes, so a pool stamped by
one package is accepted by the other's plans.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops

# Bin ids must fit uint8: ids span [0, n_borders], so 255 borders is the
# cap (CatBoost's own limit).  max_bins = n_borders + 1.
MAX_BINS = 256


def compute_borders(x: np.ndarray, max_bins: int = 64
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-feature quantile borders.

    Returns (borders (B, F) float32 padded with +inf, n_borders (F,) int32)
    on the CPU, where B = max_bins - 1.  Constant and all-NaN columns get
    zero borders (a border no sample can cross splits nothing).
    """
    if not 2 <= max_bins <= MAX_BINS:
        raise ValueError(
            f"max_bins must be in [2, {MAX_BINS}] (bin ids must fit "
            f"uint8: <= {MAX_BINS - 1} borders), got {max_bins}")
    x = np.asarray(x, np.float32)
    _, f = x.shape
    n_borders = max_bins - 1
    qs = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]       # interior quantiles
    borders = np.full((n_borders, f), np.inf, np.float32)
    counts = np.zeros((f,), np.int32)
    for j in range(f):
        col = x[:, j]
        col = col[np.isfinite(col)]
        if col.size == 0:          # all-NaN/inf column: nothing to split
            continue
        hi = col.max()
        if col.min() == hi:        # constant column: no border separates
            continue
        uniq = np.unique(np.quantile(col, qs).astype(np.float32))
        # A border is useful only if some sample lands on each side.
        uniq = uniq[np.isfinite(uniq) & (uniq < hi)]
        counts[j] = len(uniq)
        borders[:len(uniq), j] = uniq
    return torch.from_numpy(borders), torch.from_numpy(counts)


def borders_fingerprint(borders) -> str:
    """Schema fingerprint of a quantization: models sharing it accept the
    same `QuantizedPool`.

    Hashes `repr` of the numpy shape (a `torch.Size` prints differently)
    and the float32 bytes of the logical, unpadded borders, exactly as
    the JAX package does."""
    if isinstance(borders, torch.Tensor):
        borders = borders.detach().cpu().numpy()
    b = np.ascontiguousarray(np.asarray(borders, np.float32))
    h = hashlib.sha1()
    h.update(repr(b.shape).encode())
    h.update(b.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class QuantizedPool:
    """A batch binarized once: uint8 bins + the schema they were quantized
    under.  `Predictor.raw/proba/classify` score a pool without
    binarizing; the fingerprint guards against scoring it through a
    model quantized with other borders."""
    bins: torch.Tensor             # (N, F) uint8, unpadded feature axis
    fingerprint: str

    def __post_init__(self):
        if self.bins.ndim != 2:
            raise ValueError(f"pool bins must be (N, F), got shape "
                             f"{tuple(self.bins.shape)}")
        if self.bins.dtype != torch.uint8:
            raise ValueError(f"pool bins must be uint8, got "
                             f"{self.bins.dtype}")

    @property
    def n_rows(self) -> int:
        return self.bins.shape[0]

    @property
    def n_features(self) -> int:
        return self.bins.shape[1]

    def __len__(self) -> int:
        return self.n_rows

    def slice_rows(self, start: int, stop: int) -> "QuantizedPool":
        """Row-range view (serving chunks oversized pools with this)."""
        return dataclasses.replace(self, bins=self.bins[start:stop])

    def pad_rows(self, target: int) -> "QuantizedPool":
        """Zero-pad to `target` rows (bucketed serving).  Bin 0 is what a
        zero-padded float row gives against +inf-padded borders, and
        padded rows are sliced off downstream."""
        n = self.n_rows
        if n > target:
            raise ValueError(f"cannot pad {n} pool rows down to {target}")
        return dataclasses.replace(self, bins=ops.pad_dim(self.bins, 0,
                                                          target))


def quantize_pool(x, borders: torch.Tensor, *,
                  backend: str = "auto") -> QuantizedPool:
    """Binarize a float batch once into a reusable `QuantizedPool` on the
    device of `borders`.  Requires <= 255 borders (uint8 bin ids)."""
    if borders.shape[0] > MAX_BINS - 1:
        raise ValueError(
            f"quantize_pool needs <= {MAX_BINS - 1} borders for uint8 "
            f"bins, got {borders.shape[0]} (compute_borders caps "
            f"max_bins at {MAX_BINS})")
    x = torch.as_tensor(x, dtype=torch.float32, device=borders.device)
    bins = ops.binarize_u8(x.contiguous(), borders, backend=backend)
    return QuantizedPool(bins, borders_fingerprint(borders))


def quantize_pool_chunked(x_iter, borders, *, backend: str = "auto",
                          device: torch.device | str = "cuda"
                          ) -> QuantizedPool:
    """Build a `QuantizedPool` on `device` (the card unless the caller
    passes "cpu") from an iterator of float row-chunks.

    The streaming counterpart of `quantize_pool`: each (n_i, F) chunk is
    moved to the device and binarized on its own, and only its uint8 bins
    are kept (concatenated once, at the end), so float rows are in flight
    one chunk at a time while the pool equals what `quantize_pool` gives
    on the whole matrix (binarization is row-independent)."""
    from repro_torch.core.predictor import resolve_device

    borders = torch.as_tensor(borders, dtype=torch.float32)
    if borders.shape[0] > MAX_BINS - 1:
        raise ValueError(
            f"quantize_pool_chunked needs <= {MAX_BINS - 1} borders for "
            f"uint8 bins, got {borders.shape[0]}")
    device = resolve_device(device)
    on_device = borders.to(device).contiguous()
    n_features = int(borders.shape[1])
    parts: list[torch.Tensor] = []
    for chunk in x_iter:
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2 or chunk.shape[1] != n_features:
            raise ValueError(
                f"chunk shape {chunk.shape} does not match the "
                f"(n, {n_features}) the borders describe")
        if chunk.shape[0] == 0:
            continue
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
        parts.append(ops.binarize_u8(x, on_device, backend=backend))
    bins = (torch.cat(parts) if parts else
            torch.zeros((0, n_features), dtype=torch.uint8, device=device))
    return QuantizedPool(bins, borders_fingerprint(borders))


def compute_borders_chunked(x_iter, max_bins: int = 64, *,
                            sample_rows: int = 65536, seed: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """`compute_borders` over a row-chunk iterator, via reservoir sample.

    Streams (n_i, F) float chunks, keeping a uniform row reservoir of at
    most `sample_rows` rows, then computes quantile borders on the sample
    (on the CPU, as `compute_borders` returns them).  When the stream
    holds <= `sample_rows` rows the result is exactly `compute_borders` on
    the concatenated matrix; beyond that the borders are sample-quantile
    approximations, drawn from `np.random.default_rng(seed)` as the JAX
    package draws them, so both give the same borders bit for bit."""
    rng = np.random.default_rng(seed)
    reservoir: Optional[np.ndarray] = None
    seen = 0
    for chunk in x_iter:
        chunk = np.asarray(chunk, np.float32)
        if chunk.ndim != 2:
            raise ValueError(f"chunks must be (n, F), got {chunk.shape}")
        if chunk.shape[0] == 0:
            continue
        if reservoir is None:
            reservoir = np.empty((0, chunk.shape[1]), np.float32)
        if reservoir.shape[1] != chunk.shape[1]:
            raise ValueError(f"ragged chunk widths: {reservoir.shape[1]} "
                             f"then {chunk.shape[1]}")
        take = min(max(sample_rows - reservoir.shape[0], 0),
                   chunk.shape[0])
        if take:
            reservoir = np.concatenate([reservoir, chunk[:take]], axis=0)
            chunk = chunk[take:]
            seen += take
        if chunk.shape[0] == 0:
            continue
        # classic reservoir replacement for the overflow rows: stream
        # row k (0-based) replaces a uniform slot with prob S/(k+1);
        # draws are vectorized, replacements applied in stream order so
        # later rows overwrite earlier ones hitting the same slot
        draws = rng.integers(0, seen + 1 + np.arange(chunk.shape[0]))
        seen += chunk.shape[0]
        for i in np.nonzero(draws < sample_rows)[0]:
            reservoir[draws[i]] = chunk[i]
    if reservoir is None:
        raise ValueError("compute_borders_chunked needs at least one "
                         "non-empty chunk")
    return compute_borders(reservoir, max_bins)


def binarize_matrix(x: torch.Tensor, borders: torch.Tensor, *,
                    backend: str = "auto") -> torch.Tensor:
    """(N, F) float32 -> (N, F) int32 bin ids on the device of `x`: the
    escape hatch for more than 255 borders, where no uint8 pool exists
    (the JAX package's shim over `ops.binarize`)."""
    return ops.binarize(x, borders, backend=backend)
