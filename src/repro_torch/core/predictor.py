"""Compiled-plan GBDT evaluation: prepare the model once, predict many.

The port's counterpart of `src/repro/core/predictor.py`:

  plan = Predictor.build(ensemble)            # on the card by default
  plan.raw(x); plan.proba(x); plan.classify(x)
  pool = plan.quantize(x)                     # binarize once -> uint8 pool
  plan.raw(pool)                              # no binarize

`Predictor.build` resolves `auto` choices from the device (fused CUDA
kernels on the card, the staged plain versions on the CPU) and the
ensemble (the layout), moves the model to the device and lowers it once
into one of the four layouts of `core.layout`.  PyTorch runs eagerly, so
there is no jit cache; its trace counters become first-call counters per
(entry, batch shape), which keep their meaning for serving: with bucketed
batches they stay bounded by (entries used x buckets).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Literal, Optional

import torch

from repro_torch.core import layout as layout_mod
from repro_torch.core.layout import LoweredEnsemble
from repro_torch.core.quantize import (MAX_BINS, QuantizedPool,
                                       borders_fingerprint)
from repro_torch.core.trees import ObliviousEnsemble
from repro_torch.kernels import ops, registry, tuning

Strategy = Literal["auto", "staged", "fused"]

_STRATEGIES = ("auto", "staged", "fused")


@dataclasses.dataclass(frozen=True)
class PredictConfig:
    """Validated prediction-plan configuration.

      strategy   staged (binarize, index, gather as three kernels) |
                 fused (one kernel) | auto: fused on CUDA, staged on CPU
      backend    a registry backend (`torch_ref` | `cuda`) or auto: the
                 cuda kernels on CUDA, the plain versions on the CPU
      layout     soa | depth_major | depth_grouped | bitpacked (see
                 `core.layout`) | auto: `tuning.best_layout` on the
                 ensemble's true depths (soa on CUDA for now)
      tree_block staged-path tree blocking (CalcTreesBlockedImpl); 0 = off.
                 soa only: an auto layout resolves to soa with it, and
                 the fused strategy ignores it, as in the JAX package
    """
    strategy: Strategy = "auto"
    backend: str = "auto"
    layout: str = "auto"
    tree_block: int = 0

    def __post_init__(self):
        if self.strategy not in _STRATEGIES:
            raise ValueError(f"strategy must be one of {_STRATEGIES}, "
                             f"got {self.strategy!r}")
        backends = ("auto",) + registry.known_backends()
        if self.backend not in backends:
            raise ValueError(f"backend must be one of {backends}, "
                             f"got {self.backend!r}")
        layouts = ("auto",) + layout_mod.LAYOUT_NAMES
        if self.layout not in layouts:
            raise ValueError(f"layout must be one of {layouts}, "
                             f"got {self.layout!r}")
        if not isinstance(self.tree_block, int) or self.tree_block < 0:
            raise ValueError(f"tree_block must be an int >= 0, "
                             f"got {self.tree_block!r}")
        if self.tree_block and self.layout not in ("auto", "soa"):
            raise ValueError(
                f"tree_block is a soa-layout feature (the depth layouts "
                f"block by structure instead); got tree_block="
                f"{self.tree_block} with layout={self.layout!r}")

    @property
    def is_resolved(self) -> bool:
        return "auto" not in (self.strategy, self.backend, self.layout)

    def resolve(self, ensemble: ObliviousEnsemble,
                device: torch.device | str) -> "PredictConfig":
        """Concretize every `auto` choice for `ensemble` on `device`;
        refuses the plain backend for a CUDA device."""
        on_cuda = torch.device(device).type == "cuda"
        strategy = self.strategy
        if strategy == "auto":
            strategy = "fused" if on_cuda else "staged"
        backend = self.backend
        if backend == "auto":
            backend = registry.default_backend(device)
        registry.check_backend(backend, device)
        layout = self.layout
        if layout == "auto":
            layout = "soa" if self.tree_block else tuning.best_layout(
                ensemble.true_depths, ensemble.n_outputs,
                ensemble.n_features, device=device)
        return dataclasses.replace(self, strategy=strategy, backend=backend,
                                   layout=layout)


def proba_from_raw(raw: torch.Tensor, n_outputs: int) -> torch.Tensor:
    """Raw scores -> class probabilities: two-column sigmoid for binary
    models, softmax otherwise."""
    if n_outputs == 1:
        p = torch.sigmoid(raw[:, 0])
        return torch.stack([1.0 - p, p], dim=1)
    return torch.softmax(raw, dim=-1)


def classify_from_raw(raw: torch.Tensor, n_outputs: int) -> torch.Tensor:
    """Raw scores -> int32 class ids: zero threshold for binary models,
    argmax (first maximum) otherwise."""
    if n_outputs == 1:
        return (raw[:, 0] > 0.0).to(torch.int32)
    return torch.argmax(raw, dim=-1).to(torch.int32)


def resolve_device(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the "
                "caller passes device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device}")
    return device


class Predictor:
    """A prepared prediction plan for one ensemble on one device.

    Construct with `Predictor.build(...)`.  The plan owns a resolved
    `PredictConfig`, the model on its device lowered once into its
    layout, and the `raw` / `proba` / `classify` / `quantize` entries.
    Outputs are tensors on the plan's device.
    """

    def __init__(self, ensemble: ObliviousEnsemble, config: PredictConfig,
                 lowered: LoweredEnsemble, device: torch.device, *,
                 on_trace: Optional[Callable[[], None]] = None,
                 lower_time_s: float = 0.0):
        if not config.is_resolved:
            raise ValueError("Predictor requires a resolved PredictConfig; "
                             "use Predictor.build()")
        self.ensemble = ensemble
        self.config = config
        self.device = device
        self.lowered = lowered
        self._on_trace = on_trace
        self._lower_time_s = lower_time_s
        self._lock = threading.Lock()
        self._traces: dict[str, int] = {}
        self._entry_shapes: set[tuple] = set()
        self.schema_fingerprint = borders_fingerprint(ensemble.borders)
        self._entries = {
            "raw": self._raw_impl,
            "proba": lambda x: proba_from_raw(self._raw_impl(x),
                                              ensemble.n_outputs),
            "classify": lambda x: classify_from_raw(self._raw_impl(x),
                                                    ensemble.n_outputs),
            "raw_pool": self._pool_raw_impl,
            "proba_pool": lambda b: proba_from_raw(self._pool_raw_impl(b),
                                                   ensemble.n_outputs),
            "classify_pool": lambda b: classify_from_raw(
                self._pool_raw_impl(b), ensemble.n_outputs),
            "quantize": self._quantize_impl,
        }

    @classmethod
    def build(cls, ensemble: ObliviousEnsemble,
              config: Optional[PredictConfig] = None, *,
              device: torch.device | str = "cuda",
              on_trace: Optional[Callable[[], None]] = None,
              **config_kw: Any) -> "Predictor":
        """Resolve the config for `device` and prepare the model: the only
        place any per-ensemble preparation happens.  `config_kw` is a
        convenience for `Predictor.build(ens, strategy="staged")` style
        calls; it cannot be combined with an explicit `config`."""
        if config is None:
            config = PredictConfig(**config_kw)
        elif config_kw:
            raise TypeError("pass either a PredictConfig or config kwargs, "
                            f"not both: {sorted(config_kw)}")
        device = resolve_device(device)
        resolved = config.resolve(ensemble, device)
        t0 = time.perf_counter()
        on_device = ensemble.to(device)
        lowered = layout_mod.lower(
            on_device, resolved.layout,
            tree_block=(resolved.tree_block
                        if resolved.strategy == "staged" else 0))
        return cls(on_device, resolved, lowered, device, on_trace=on_trace,
                   lower_time_s=time.perf_counter() - t0)

    # -- entries -----------------------------------------------------------
    def _raw_impl(self, x: torch.Tensor) -> torch.Tensor:
        cfg, p = self.config, self.lowered
        base = self.ensemble.base_score[None, :]
        if cfg.strategy == "fused":
            return base + p.fused_raw(x, backend=cfg.backend)
        bins = ops.binarize_prepadded(x, p.borders, backend=cfg.backend)
        return base + p.leaf_sum(bins, backend=cfg.backend)

    def _pool_raw_impl(self, bins: torch.Tensor) -> torch.Tensor:
        base = self.ensemble.base_score[None, :]
        return base + self.lowered.leaf_sum(bins, backend=self.config.backend)

    def _quantize_impl(self, x: torch.Tensor) -> torch.Tensor:
        return ops.binarize_u8_prepadded(x, self.lowered.borders,
                                         backend=self.config.backend)

    def _note_call(self, name: str, shape: tuple) -> None:
        """Count the first call of each (entry, batch shape): the
        counterpart of the JAX package's per-trace counter."""
        key = (name,) + tuple(shape)
        with self._lock:
            if key in self._entry_shapes:
                return
            self._entry_shapes.add(key)
            self._traces[name] = self._traces.get(name, 0) + 1
        if self._on_trace is not None:
            self._on_trace()

    def _check_pool(self, pool: QuantizedPool) -> None:
        if pool.fingerprint != self.schema_fingerprint:
            raise ValueError(
                "QuantizedPool schema mismatch: pool was quantized under "
                f"fingerprint {pool.fingerprint} but this plan's borders "
                f"have fingerprint {self.schema_fingerprint}; its "
                "split_bins would index a different bin space.  "
                "Re-quantize with this plan's `quantize(x)`.")

    def _as_input(self, x) -> tuple[str, torch.Tensor]:
        """(entry suffix, tensor on the plan's device) for floats or a
        pool."""
        if isinstance(x, QuantizedPool):
            self._check_pool(x)
            return "_pool", x.bins.to(self.device).contiguous()
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.ndim != 2 or x.shape[1] != self.ensemble.n_features:
            raise ValueError(f"expected (N, {self.ensemble.n_features}) "
                             f"features, got {tuple(x.shape)}")
        return "", x.contiguous()

    def _call(self, name: str, x) -> torch.Tensor:
        suffix, data = self._as_input(x)
        entry = name + suffix
        self._note_call(entry, data.shape)
        return self._entries[entry](data)

    # -- public entry points -----------------------------------------------
    def quantize(self, x) -> QuantizedPool:
        """Binarize a float batch once into a reusable uint8
        `QuantizedPool` on the plan's device."""
        if self.ensemble.borders.shape[0] > MAX_BINS - 1:
            raise ValueError(
                f"cannot quantize to uint8 bins: ensemble has "
                f"{self.ensemble.borders.shape[0]} borders "
                f"(> {MAX_BINS - 1})")
        return QuantizedPool(self._call("quantize", x),
                             self.schema_fingerprint)

    def raw(self, x) -> torch.Tensor:
        """(N, F) floats or a `QuantizedPool` -> (N, C) raw scores (tree
        sum + base score).  The pool path never binarizes."""
        return self._call("raw", x)

    def proba(self, x) -> torch.Tensor:
        """(N, F) floats or a `QuantizedPool` -> (N, max(C, 2)) class
        probabilities."""
        return self._call("proba", x)

    def classify(self, x) -> torch.Tensor:
        """(N, F) floats or a `QuantizedPool` -> (N,) int32 class ids."""
        return self._call("classify", x)

    def raw_uncached(self, x) -> torch.Tensor:
        """`raw` without touching the first-call counters."""
        suffix, data = self._as_input(x)
        return self._entries["raw" + suffix](data)

    @property
    def stats(self) -> dict[str, Any]:
        """First calls per entry point, distinct (entry, batch shape) keys
        seen, the layout and the one-time lowering cost."""
        with self._lock:
            return {
                "traces": dict(self._traces),
                "total_traces": sum(self._traces.values()),
                "cache_entries": len(self._entry_shapes),
                "entry_shapes": sorted(self._entry_shapes),
                "layout": self.config.layout,
                "lower_time_s": self._lower_time_s,
            }

    def describe(self) -> dict[str, Any]:
        return {**self.ensemble.describe(),
                "strategy": self.config.strategy,
                "backend": self.config.backend,
                "layout": self.config.layout,
                "tree_block": self.config.tree_block,
                "device": str(self.device),
                "schema_fingerprint": self.schema_fingerprint,
                "lowered": self.lowered.describe()}

    def __repr__(self) -> str:
        c = self.config
        return (f"<Predictor {c.strategy}/{c.backend}/{c.layout} "
                f"on {self.device} trees={self.ensemble.n_trees} "
                f"depth={self.ensemble.depth} C={self.ensemble.n_outputs}>")
