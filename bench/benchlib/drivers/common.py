"""Pieces the drivers share."""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def phase(parts: dict, name: str):
    """Add the block's seconds to `parts[name]` (set-up's breakdown); the
    card is synchronized at the block's end so that its work counts."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0


def host_span(name: str):
    """A named host range in the profiler's trace (what the benchmark was
    doing on the host while the device idled); a no-op cost otherwise."""
    return torch.profiler.record_function(name)


def mesh_device(devices) -> str:
    """The device kind `make_local_mesh` deals its shards over."""
    return "cpu" if devices[0].type == "cpu" else "cuda"


def model_shape(cfg: dict) -> dict:
    """The sizes the frozen cost formulas take."""
    return {"features": cfg["features"], "borders": cfg["border_count"],
            "trees": cfg["trees"], "depth": cfg["depth"],
            "outputs": cfg["n_outputs"]}


def max_abs_err(got, want) -> float:
    """The largest absolute difference, or inf where the shapes differ or
    the program gave a value that is not finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.max(np.abs(got - want))) if got.size else 0.0
