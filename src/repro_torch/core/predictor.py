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
import json
import pathlib
import threading
import time
from typing import Any, Callable, Literal, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import layout as layout_mod
from repro_torch.core.layout import STAGED_TREE_ALIGN, LoweredEnsemble
from repro_torch.core.quantize import (MAX_BINS, QuantizedPool,
                                       borders_fingerprint)
from repro_torch.core.trees import ObliviousEnsemble
from repro_torch.kernels import ops, registry, tuning
from repro_torch.kernels.ops import PAD_SPLIT_BIN
from repro_torch.obs.trace import get_tracer

Strategy = Literal["auto", "staged", "fused"]

_TRACER = get_tracer()
_STRATEGIES = ("auto", "staged", "fused")

# Set on a thread while `Predictor.trace_entries` walks a plan: its calls
# count no first call.
_WALKING = threading.local()


def _host_to_card(rows: torch.Tensor, device: torch.device) -> bool:
    """Whether moving `rows` to `device` copies host memory to a card."""
    return rows.device.type == "cpu" and device.type == "cuda"


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
        self._first_calls: set[tuple] = set()
        # the lowered model on each device a mesh put it on: the plan's own
        # arrays on its own device, one copy on every other
        self._replicas: dict[torch.device, LoweredEnsemble] = {
            device: lowered}
        self._sharded_cache: dict[tuple, Callable] = {}
        self._abstract_traces: dict[tuple, Any] = {}
        self._abstract_trace_misses = 0
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

    @classmethod
    def from_catboost_json(cls, path: str | pathlib.Path,
                           config: Optional[PredictConfig] = None, *,
                           device: torch.device | str = "cuda",
                           **build_kw: Any) -> "Predictor":
        """Build a plan straight from a CatBoost JSON model export, on
        `device` (the card unless the caller passes "cpu")."""
        return cls.build(load_catboost_json(path), config, device=device,
                         **build_kw)

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

    def _note_call(self, name: str, shape: tuple, *, scope: tuple = (),
                   **attrs: Any) -> None:
        """Count the first call of each (entry, batch shape) within
        `scope` (a mesh closure and its shard mode; the plan's own entries
        have none): the counterpart of the JAX package's per-trace
        counter.  `attrs` go on the `compile/<entry>` instant."""
        if getattr(_WALKING, "on", False):
            return
        key = (name,) + tuple(shape)
        with self._lock:
            if scope + key in self._first_calls:
                return
            self._first_calls.add(scope + key)
            self._entry_shapes.add(key)
            self._traces[name] = self._traces.get(name, 0) + 1
        if _TRACER.enabled:
            # one instant per first call: the timeline marker of every
            # new (entry, batch shape)
            _TRACER.instant(f"compile/{name}", "compile", entry=name,
                            layout=self.config.layout,
                            batch=int(shape[0]) if shape else 0, **attrs)
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

    def _float_rows(self, x) -> torch.Tensor:
        """(N, F) float32 rows where they are (no device move)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.ndim != 2 or x.shape[1] != self.ensemble.n_features:
            raise ValueError(f"expected (N, {self.ensemble.n_features}) "
                             f"features, got {tuple(x.shape)}")
        return x.contiguous()

    def _as_input(self, x) -> tuple[str, torch.Tensor]:
        """(entry suffix, tensor on the plan's device) for floats or a
        pool.  While tracing, the copy of host rows to the card is a
        `plan/h2d` span."""
        if isinstance(x, QuantizedPool):
            self._check_pool(x)
            return "_pool", x.bins.to(self.device).contiguous()
        rows = self._float_rows(x)
        if _TRACER.enabled and _host_to_card(rows, self.device):
            with _TRACER.span("plan/h2d", "plan", device=self.device,
                              rows=int(rows.shape[0]),
                              bytes=rows.numel() * rows.element_size(),
                              pinned=rows.is_pinned()):
                return "", rows.to(self.device)
        return "", rows.to(self.device)

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

    # -- the mesh ----------------------------------------------------------
    def _shard_raw(self, lw: LoweredEnsemble, data: torch.Tensor,
                   kind: str, cfg: PredictConfig) -> torch.Tensor:
        """Shard-local raw tree sum (no base score) over one lowered model,
        the plan's own or one tree shard of it: the body every mesh shard
        runs, through the registry's dispatch for any layout.  `kind` is
        "pool" (uint8 bins; binarize never runs) or "float"."""
        if kind == "pool":
            return lw.leaf_sum(data, backend=cfg.backend)
        if cfg.strategy == "fused":
            return lw.fused_raw(data, backend=cfg.backend)
        bins = ops.binarize_prepadded(data, lw.borders, backend=cfg.backend)
        return lw.leaf_sum(bins, backend=cfg.backend)

    def _replica(self, device: torch.device) -> LoweredEnsemble:
        """The lowered model on `device`: one copy a distinct device, made
        at first use, however many shards of a mesh lie on it."""
        with self._lock:
            lw = self._replicas.get(device)
            if lw is None:
                lw = layout_mod.to_device(self.lowered, device)
                self._replicas[device] = lw
            return lw

    def sharded(self, mesh, *, data_axes: Sequence[str] = ("data",),
                model_axis: str = "model",
                strategy: Optional[str] = None,
                shard_axis: str = "auto") -> Callable[[Any], torch.Tensor]:
        """Mesh-distributed raw scores over floats, a `QuantizedPool`, or
        the per-shard row chunks of `core.predict.shard_inputs`.

        One process drives every shard of `mesh` (a
        `distributed.mesh.Mesh`), as `shard_map` does in the JAX package;
        each shard runs `_shard_raw`, the single-device plan's own
        registry-dispatched kernels on the plan's layout, on its device:

          * **row sharding** (the bulk default): the lowered model is
            replicated (one copy a distinct device; the plan's own arrays
            on the plan's device), the rows are cut into equal shards over
            `data_axes`; a pool shards its uint8 bins, so binarize never
            runs, and the result is bit for bit the single-device plan's.
          * **tree sharding** (giant ensembles): `layout.shard_trees`
            splits the tree axis into neutral-padded equal slices over
            the mesh; the shards' partial (N, C) sums are added in shard
            order on the mesh's first device (the JAX package's `psum`:
            a reassociated float sum, so parity is to rounding).
          * **hybrid**: a mesh whose `model_axis` has more than one shard
            splits rows over `data_axes` and trees over `model_axis`.

        `shard_axis` ("rows" | "trees" | "auto") picks how a pure data
        mesh is used; "auto" asks `tuning.best_shard_axis` per batch.  A
        row count the row shards do not divide is padded with zero rows
        and sliced back.  Outputs are concatenated in shard order on the
        mesh's first device.  `strategy` overrides the plan's strategy
        for the shard body (serving passes "staged" for auto plans).  The
        closure is built once per (mesh, axes, strategy, shard_axis) and
        cached on the plan.  A cross-device `.to()` orders the copy
        against both devices' current streams, so the shards need no
        synchronize of their own.
        """
        key = (id(mesh), tuple(data_axes), model_axis, strategy,
               shard_axis)
        fn = self._sharded_cache.get(key)
        if fn is not None:
            return fn
        if shard_axis not in ("auto", "rows", "trees"):
            raise ValueError(f"shard_axis must be auto|rows|trees, "
                             f"got {shard_axis!r}")
        cfg = self.config
        if strategy is not None and strategy != cfg.strategy:
            if strategy not in ("staged", "fused"):
                raise ValueError(f"strategy must be staged or fused, "
                                 f"got {strategy!r}")
            cfg = dataclasses.replace(cfg, strategy=strategy)
        lowered, ens = self.lowered, self.ensemble

        axis_sizes = dict(mesh.shape)
        flat = [_concrete(d) for d in mesh.device_list]
        for device in set(flat):
            registry.check_backend(cfg.backend, device)
        first = flat[0]
        base = self.ensemble.base_score.to(first).unsqueeze(0)
        row_axes = tuple(a for a in data_axes if a in axis_sizes)
        tree_on_model = (model_axis in axis_sizes
                         and axis_sizes[model_axis] > 1)

        def n_shards(axes) -> int:
            return int(np.prod([axis_sizes[a] for a in axes], dtype=int))

        # mode -> (row axes, tree axes); "trees" on a pure data mesh
        # reuses the data axes as the model split
        modes: dict[str, tuple[tuple, tuple]] = {}
        if tree_on_model:
            modes["hybrid"] = (row_axes, (model_axis,))
            pick = lambda n: "hybrid"                     # noqa: E731
        elif shard_axis == "trees":
            modes["trees"] = ((), row_axes)
            pick = lambda n: "trees"                      # noqa: E731
        elif shard_axis == "rows" or n_shards(row_axes) <= 1:
            modes["rows"] = (row_axes, ())
            pick = lambda n: "rows"                       # noqa: E731
        else:
            modes["rows"] = (row_axes, ())
            modes["trees"] = ((), row_axes)
            k = n_shards(row_axes)

            def pick(n):
                return tuning.best_shard_axis(
                    n, ens.n_trees, k, n_outputs=ens.n_outputs,
                    leaf_table_bytes=lowered.leaf_table_bytes())

        entries: dict[str, tuple] = {}

        def entry(mode: str) -> tuple:
            cached = entries.get(mode)
            if cached is not None:
                return cached
            r_axes, t_axes = modes[mode]
            devices = [[_concrete(d) for d in row]
                       for row in mesh.shard_devices(r_axes, t_axes)]
            n_tree = n_shards(t_axes)
            if n_tree > 1:
                stacked = layout_mod.stack_tree_shards(
                    layout_mod.shard_trees(lowered, n_tree,
                                           t_align=STAGED_TREE_ALIGN))
                moved: dict[tuple, LoweredEnsemble] = {}
                for row in devices:
                    for j, dev in enumerate(row):
                        if (j, dev) not in moved:
                            moved[j, dev] = layout_mod.to_device(
                                layout_mod.unstack_tree_shard(stacked, j),
                                dev)
                models = [[moved[j, dev] for j, dev in enumerate(row)]
                          for row in devices]
            else:
                models = [[self._replica(dev) for dev in row]
                          for row in devices]
            entries[mode] = cached = (n_shards(r_axes), n_tree, devices,
                                      models)
            return cached

        n_devices = mesh.size

        def split_rows(data, n: int, n_row: int):
            """(row shards, padded row count): `shard_inputs`' chunks as
            they are when they fit the mode, else equal slices of the
            zero-padded rows (views, after at most one host copy)."""
            if isinstance(data, list):
                if len(data) == n_row and \
                        len({int(p.shape[0]) for p in data}) == 1:
                    return data, n
                data = torch.cat([p.to(first) for p in data])
            if data.device.type == "cpu" and first.type != "cpu":
                data = data.to(first)
            n_pad = -(-n // n_row) * n_row
            data = ops.pad_dim(data, 0, n_pad)
            per = n_pad // n_row
            return [data.narrow(0, i * per, per)
                    for i in range(n_row)], n_pad

        def run(mode: str, kind: str, data, n: int) -> torch.Tensor:
            n_row, n_tree, devices, models = entry(mode)
            parts, n_pad = split_rows(data, n, n_row)
            self._note_call(f"sharded_{kind}",
                            (n_pad,) + tuple(parts[0].shape[1:]),
                            scope=(key, mode), shard_mode=mode,
                            row_shards=n_row, tree_shards=n_tree)
            # every shard's input copy, then every shard's kernels, then
            # the results: a cross-device copy makes each device's stream
            # wait for the other's, so a result fetched between two shards'
            # launches would hold the next shard behind it and serialize
            # the cards
            inputs = [[part.to(dev) for dev in row]
                      for part, row in zip(parts, devices)]
            partial = [[self._shard_raw(lw, x_dev, kind, cfg)
                        for lw, x_dev in zip(row_models, row_inputs)]
                       for row_models, row_inputs in zip(models, inputs)]
            outs = []
            for row in partial:
                acc = None
                for got in row:
                    got = got.to(first)
                    acc = got if acc is None else acc + got
                outs.append(acc)
            out = base + torch.cat(outs)
            return out.narrow(0, 0, n) if n_pad != n else out

        def fn(x) -> torch.Tensor:
            if isinstance(x, QuantizedPool):
                self._check_pool(x)
                data, kind = x.bins, "pool"
                n = int(data.shape[0])
            elif isinstance(x, (list, tuple)):
                data, kind = [self._float_rows(p) for p in x], "float"
                n = sum(int(p.shape[0]) for p in data)
            else:
                data, kind = self._float_rows(x), "float"
                n = int(data.shape[0])
            mode = pick(n)
            if not _TRACER.enabled:
                return run(mode, kind, data, n)
            with _TRACER.span(f"sharded/{kind}", "sharded", device=first,
                              shard_axis=mode, devices=n_devices, rows=n,
                              layout=cfg.layout):
                return run(mode, kind, data, n)

        self._sharded_cache[key] = fn
        return fn

    # -- introspection -----------------------------------------------------
    def trace_entries(self, batch_sizes: Sequence[int] = (8,),
                      entries: Optional[Sequence[str]] = None, *,
                      mesh=None, input_dtype: Optional[torch.dtype] = None
                      ) -> dict[str, Any]:
        """Abstract traces (`analysis.trace_tools.Trace`) of the plan's
        entry points: the surface the contract checker's transfer, retrace
        and shard-parity lints walk.

        Each entry runs as `raw` / `proba` / ... run it (the input's checks
        and moves, then the entry), on fake tensors of the plan's device
        under `FakeTensorMode` with every op and kernel launch recorded:
        nothing is computed or launched, no first call is counted
        (`stats['traces']` does not tick) and the launch and dispatch
        counts are left as they were.  Repeat walks of one (entry, batch
        shape, dtype) under one quantization schema come from a cache
        keyed like `QuantizedPool` scoring, on the borders fingerprint.
        Returns {"<entry>@<batch>": Trace}.

        Pool entries and `quantize` are left out when the ensemble has
        more borders than uint8 bins hold; `entries` pins a list.  With
        `mesh` (a `distributed.mesh.Mesh`, fake devices welcome), the
        row-sharded entries join as `sharded_raw` / `sharded_raw_pool`
        (batch sizes must divide the mesh).  `input_dtype` feeds every
        entry inputs of that dtype instead (the retrace lint's float64
        rows and int32 bins); an entry that refuses it is left out."""
        from repro_torch.analysis import trace_tools
        impls = {"raw": torch.float32, "proba": torch.float32,
                 "classify": torch.float32, "raw_pool": torch.uint8,
                 "proba_pool": torch.uint8, "classify_pool": torch.uint8,
                 "quantize": torch.float32}
        mesh_key = None
        if mesh is not None:
            mesh_key = (tuple(dict(mesh.shape).items()),
                        tuple(str(d) for d in mesh.device_list))
            impls["sharded_raw"] = torch.float32
            impls["sharded_raw_pool"] = torch.uint8
        if entries is None:
            names = list(impls)
            if self.ensemble.borders.shape[0] > MAX_BINS - 1:
                names = [n for n in names
                         if not n.endswith("_pool") and n != "quantize"]
        else:
            unknown = sorted(set(entries) - set(impls))
            if unknown:
                raise KeyError(f"unknown plan entries {unknown}; "
                               f"known: {sorted(impls)}")
            names = list(entries)
        mode = trace_tools.fake_mode_of(
            self.ensemble.base_score, self.lowered.borders) \
            or trace_tools.new_fake_mode()
        out: dict[str, Any] = {}
        for name in names:
            dtype = input_dtype or impls[name]
            for n in batch_sizes:
                shape = (int(n), self.ensemble.n_features)
                key = (name, shape, str(dtype), self.schema_fingerprint,
                       mesh_key if name.startswith("sharded") else None)
                with self._lock:
                    traced = self._abstract_traces.get(key)
                if traced is None:
                    try:
                        traced = self._trace_entry(name, shape, dtype,
                                                   mode, mesh)
                    except (ValueError, TypeError):
                        if input_dtype is None:
                            raise
                        continue
                    with self._lock:
                        traced = self._abstract_traces.setdefault(key,
                                                                  traced)
                        self._abstract_trace_misses += 1
                out[f"{name}@{int(n)}"] = traced
        return out

    def _trace_entry(self, name: str, shape: tuple, dtype: torch.dtype,
                     mode, mesh):
        from repro_torch.analysis import trace_tools
        replicas, sharded = dict(self._replicas), dict(self._sharded_cache)
        _WALKING.on = True
        try:
            with trace_tools.recording(mode) as trace:
                x = torch.empty(shape, dtype=dtype, device=self.device)
                arg = QuantizedPool(x, self.schema_fingerprint) \
                    if name.endswith("_pool") else x
                if name.startswith("sharded"):
                    out = self.sharded(mesh, shard_axis="rows")(arg)
                else:
                    _, data = self._as_input(arg)
                    out = self._entries[name](data)
                trace_tools.mark_io(trace, [x], out)
        finally:
            _WALKING.on = False
            # a walk over a mesh of fake devices leaves no fake replica or
            # closure behind
            with self._lock:
                self._replicas, self._sharded_cache = replicas, sharded
        return trace

    @property
    def stats(self) -> dict[str, Any]:
        """First calls per entry point, distinct (entry, batch shape) keys
        seen, the layout, the one-time lowering cost and the abstract
        walks traced (`trace_entries`)."""
        with self._lock:
            return {
                "traces": dict(self._traces),
                "total_traces": sum(self._traces.values()),
                "cache_entries": len(self._entry_shapes),
                "entry_shapes": sorted(self._entry_shapes),
                "layout": self.config.layout,
                "lower_time_s": self._lower_time_s,
                "abstract_trace_misses": self._abstract_trace_misses,
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


def _concrete(device) -> torch.device:
    """A mesh entry as a device with an index (CUDA's current device for a
    bare "cuda"), so that equal devices compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


# --------------------------------------------------------------------------
# CatBoost JSON ingestion
# --------------------------------------------------------------------------
def load_catboost_json(path: str | pathlib.Path) -> ObliviousEnsemble:
    """Parse a CatBoost oblivious-tree JSON export into an ensemble on the
    CPU (a plan moves it to its device).

    Reads the subset of `save_model(..., format="json")` the paper's
    workloads need: `features_info.float_features[*].borders`,
    `oblivious_trees[*].splits` (float splits only: feature index +
    border value) and flat `leaf_values`, plus `scale_and_bias`.  The
    JAX package's `load_catboost_json` gives the same arrays.

    Conventions mapped onto this repo's model:
      * split j of a tree contributes bit j of the leaf index
        (CatBoost lists splits bottom-up, matching `ref.leaf_index`)
      * CatBoost's `x > border` with border at sorted index k becomes
        `bins >= k + 1` in quantized space
      * trees shallower than the deepest are padded with always-left
        splits (`PAD_SPLIT_BIN`), their leaf values at indices < 2^d
      * `leaf_values` is length 2^d * dim, leaf-major
    """
    obj = json.loads(pathlib.Path(path).read_text())
    floats = obj.get("features_info", {}).get("float_features", [])
    if not floats:
        raise ValueError(f"{path}: no features_info.float_features — not a "
                         "CatBoost JSON model export?")
    trees = obj.get("oblivious_trees", [])
    if not trees:
        raise ValueError(f"{path}: no oblivious_trees (only oblivious-tree "
                         "models are supported)")
    for t, tree in enumerate(trees):
        if "splits" not in tree or "leaf_values" not in tree:
            raise ValueError(f"{path}: tree {t} is missing "
                             "splits/leaf_values — truncated export?")

    def flat_index(feat, i):
        return int(feat.get("flat_feature_index",
                            feat.get("feature_index", i)))

    n_features = 1 + max(flat_index(f, i) for i, f in enumerate(floats))
    per_feature: list[list[float]] = [[] for _ in range(n_features)]
    for i, f in enumerate(floats):
        per_feature[flat_index(f, i)] = [float(v)
                                         for v in (f.get("borders") or [])]

    depth = max(len(t["splits"]) for t in trees)
    if depth < 1:
        raise ValueError(f"{path}: model has splitless trees only")
    d0 = len(trees[0]["splits"])
    n_leaf0 = len(trees[0]["leaf_values"])
    if n_leaf0 % (1 << d0):
        raise ValueError(f"{path}: tree 0 has {n_leaf0} leaf values, not a "
                         f"multiple of 2^depth={1 << d0}")
    n_outputs = n_leaf0 // (1 << d0)

    n_trees = len(trees)
    sf = np.zeros((n_trees, depth), np.int32)
    sb = np.full((n_trees, depth), PAD_SPLIT_BIN, np.int32)
    lv = np.zeros((n_trees, 1 << depth, n_outputs), np.float32)
    for t, tree in enumerate(trees):
        splits = tree["splits"]
        d = len(splits)
        vals = np.asarray(tree["leaf_values"], np.float32)
        if vals.size != (1 << d) * n_outputs:
            raise ValueError(
                f"{path}: tree {t} has {vals.size} leaf values; expected "
                f"2^{d} * {n_outputs} (inconsistent approx dimension)")
        for j, s in enumerate(splits):
            stype = s.get("split_type", "FloatFeature")
            if stype != "FloatFeature":
                raise ValueError(f"{path}: tree {t} split {j} has type "
                                 f"{stype!r}; only FloatFeature is "
                                 "supported")
            fi = int(s.get("float_feature_index",
                           s.get("feature_index", -1)))
            if not 0 <= fi < n_features:
                raise ValueError(f"{path}: tree {t} split {j} references "
                                 f"feature {fi} outside [0, {n_features})")
            if "border" not in s:
                raise ValueError(f"{path}: tree {t} split {j} has no "
                                 "border value")
            border = float(s["border"])
            feature_borders = per_feature[fi]
            if not feature_borders:
                raise ValueError(f"{path}: tree {t} splits on feature {fi} "
                                 "which has no borders")
            k = int(np.argmin(np.abs(np.asarray(feature_borders) - border)))
            if not np.isclose(feature_borders[k], border,
                              rtol=1e-6, atol=1e-9):
                raise ValueError(
                    f"{path}: tree {t} split {j} border {border} not found "
                    f"among feature {fi}'s borders")
            sf[t, j] = fi
            sb[t, j] = k + 1
        lv[t, :1 << d, :] = vals.reshape(1 << d, n_outputs)

    scale, bias = 1.0, np.zeros((n_outputs,), np.float32)
    snb = obj.get("scale_and_bias")
    if snb:
        scale = float(snb[0])
        raw_bias = snb[1]
        if isinstance(raw_bias, (int, float)):
            raw_bias = [raw_bias]
        b = np.asarray(raw_bias, np.float32)
        if b.size == 1:
            bias = np.full((n_outputs,), float(b[0]), np.float32)
        elif b.size == n_outputs:
            bias = b
        else:
            raise ValueError(f"{path}: scale_and_bias bias has {b.size} "
                             f"entries for {n_outputs} outputs")

    n_borders = np.asarray([len(b) for b in per_feature], np.int32)
    max_b = max(1, int(n_borders.max()))
    borders = np.full((max_b, n_features), np.inf, np.float32)
    for fi, vals in enumerate(per_feature):
        borders[:len(vals), fi] = vals

    return ObliviousEnsemble(
        split_features=torch.from_numpy(sf),
        split_bins=torch.from_numpy(sb),
        leaf_values=torch.from_numpy(lv * np.float32(scale)),
        borders=torch.from_numpy(borders),
        n_borders=torch.from_numpy(n_borders),
        base_score=torch.from_numpy(bias),
    )
