"""Kernel registry: named implementations per op, chosen by device.

The port's counterpart of `src/repro/kernels/registry.py`.  Each op
registers named implementations with capability metadata:

  op        one of CORE_OPS
  name      "torch_ref" (the plain PyTorch versions, for CPU data) or
            "cuda" (the hand-written kernels, for CUDA data)
  family    torch_ref | cuda
  dtypes    bin-stream dtypes the implementation produces or consumes
            (binarize takes the output dtype as an argument)
  devices   the device type the implementation runs on
  layouts   the physical model layouts (`core.layout`) whose arrays it
            takes: the `_dm` / `_bp` implementations take the (D, T)
            planes of depth_major / bitpacked, and `resolve(...,
            layout=)` routes to them by name suffix

The registry is the one place that picks the code for a device: `auto`
resolves to `cuda` on a CUDA device and to `torch_ref` on the CPU, and a
family named for the other device is refused, so a plan on the card never
runs the plain versions and `backend="cuda"` never quietly does on the CPU.

`dispatch` ticks a per-op counter, so "no binarize while scoring a
quantized pool" is a checkable invariant.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

import torch

from repro_torch.obs.trace import get_tracer

_TRACER = get_tracer()

# The ops every backend family covers: the four of the serving path, the
# training histogram and the kNN distances (`l2sq`, rowwise for a 1-d
# query, the matrix form for 2-d queries).
CORE_OPS = ("binarize", "leaf_index", "leaf_gather", "l2sq",
            "fused_predict", "histogram")
FAMILIES = ("torch_ref", "cuda")


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One registered implementation of one op."""
    op: str
    name: str
    fn: Callable[..., Any]
    family: str
    dtypes: tuple[str, ...]
    devices: tuple[str, ...]
    layouts: tuple[str, ...]
    constraints: str


_REGISTRY: dict[str, dict[str, KernelImpl]] = {}
_CALL_STATS: dict[str, int] = {}
# The bulk scorer dispatches from two threads (its prefetch worker and the
# caller's), so each count is a locked read-modify-write.
_CALL_STATS_LOCK = threading.Lock()


def register(op: str, name: str, *, dtypes: tuple[str, ...] = ("int32",),
             layouts: tuple[str, ...] = ("soa",),
             constraints: str = "") -> Callable:
    """Decorator: register `fn` as implementation `name` of `op`.  The
    family is the name's prefix; registering a name twice is an error.
    `layouts` names the layouts whose arrays `fn` takes (ops that read
    no model structure, binarize and leaf_gather, claim every layout)."""
    family = next((f for f in FAMILIES if name.startswith(f)), None)
    if family is None:
        raise ValueError(f"implementation {name!r} belongs to no family "
                         f"{FAMILIES}")

    def deco(fn: Callable) -> Callable:
        impls = _REGISTRY.setdefault(op, {})
        if name in impls:
            raise ValueError(f"kernel impl {op}:{name} already registered")
        impls[name] = KernelImpl(
            op=op, name=name, fn=fn, family=family, dtypes=tuple(dtypes),
            devices=("cuda",) if family == "cuda" else ("cpu",),
            layouts=tuple(layouts), constraints=constraints)
        return fn
    return deco


def ops() -> list[str]:
    return sorted(_REGISTRY)


def implementations(op: str) -> dict[str, KernelImpl]:
    if op not in _REGISTRY:
        raise KeyError(f"unknown kernel op {op!r}; registered: {ops()}")
    return dict(_REGISTRY[op])


def get(op: str, name: str) -> KernelImpl:
    impls = implementations(op)
    if name not in impls:
        raise KeyError(f"op {op!r} has no implementation {name!r}; "
                       f"available: {sorted(impls)}")
    return impls[name]


def default_backend(device: torch.device | str) -> str:
    """The `auto` resolution: the cuda kernels on a CUDA device, the
    plain versions on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch_ref"


def known_backends() -> tuple[str, ...]:
    """Backend names valid as a `PredictConfig.backend`: implementation
    names registered for every core op."""
    names: Optional[set] = None
    for op in CORE_OPS:
        impls = set(_REGISTRY.get(op, {}))
        names = impls if names is None else names & impls
    return tuple(sorted(names or ()))


def check_backend(backend: str, device: torch.device | str) -> None:
    """Refuse a family meant for the other device: the plain versions for
    data on the card, the kernels for data on the CPU."""
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda and backend.startswith("torch_ref"):
        raise ValueError(
            f"backend {backend!r} runs the plain PyTorch versions; a CUDA "
            "plan runs the cuda kernels (use backend='cuda' or 'auto')")
    if not on_cuda and backend.startswith("cuda"):
        raise ValueError(
            f"backend {backend!r} launches CUDA kernels; data on the CPU "
            "runs the plain versions (use backend='torch_ref' or 'auto')")


# Layout -> suffix of the sibling implementation that takes that
# layout's arrays, tried when the backend's own does not.
_LAYOUT_SUFFIX = {"depth_major": "dm", "bitpacked": "bp"}


def resolve(op: str, backend: str = "auto", *,
            device: torch.device | str = "cpu",
            dtype: Optional[str] = None,
            layout: Optional[str] = None) -> str:
    """Map a backend (`auto`, a family, or an exact implementation name)
    to the implementation to run on `device`.  When `layout` is given and
    that implementation does not take the layout's arrays, its
    `<name>_dm` / `<name>_bp` sibling is taken instead; one that does
    not handle `dtype`, when that is given, is refused."""
    name = default_backend(device) if backend == "auto" else backend
    check_backend(name, device)
    impls = implementations(op)
    if name not in impls:
        raise KeyError(f"op {op!r} has no implementation {name!r}; "
                       f"available: {sorted(impls)} (backends: "
                       f"{known_backends()} or 'auto')")
    if layout is not None and layout not in impls[name].layouts:
        alt = f"{name}_{_LAYOUT_SUFFIX[layout]}" \
            if layout in _LAYOUT_SUFFIX else None
        if alt not in impls or layout not in impls[alt].layouts:
            raise ValueError(
                f"op {op!r} implementation {name!r} does not take layout "
                f"{layout!r} (takes {impls[name].layouts}) and has no "
                f"{layout} sibling")
        name = alt
    if dtype is not None and dtype not in impls[name].dtypes:
        raise ValueError(
            f"op {op!r} implementation {name!r} does not handle dtype "
            f"{dtype!r} (handles {impls[name].dtypes})")
    return name


def dispatch(op: str, backend: str, *args: Any,
             dtype: Optional[str] = None, layout: Optional[str] = None,
             **kw: Any) -> Any:
    """Resolve against the first argument's device, count, and call.

    While the tracer is enabled each dispatch records a `dispatch/<op>`
    span tagged (op, impl, layout, bin dtype, operand shapes, scalar
    keywords; the CUDA wrapper adds its plan), with CUDA events on the
    card that become its `device_ms` at export, and a `dispatch_count`
    counter sample.  Disabled, the cost is one attribute load and a
    bool test: no span arguments are built."""
    impl = get(op, resolve(op, backend, device=args[0].device, dtype=dtype,
                           layout=layout))
    with _CALL_STATS_LOCK:
        count = _CALL_STATS[op] = _CALL_STATS.get(op, 0) + 1
    if not _TRACER.enabled:
        return impl.fn(*args, **kw)
    attrs: dict[str, Any] = {"op": op, "impl": impl.name,
                             "layout": layout or "-",
                             "dtype": dtype or "-"}
    shapes = [tuple(int(d) for d in a.shape)
              for a in args if isinstance(a, torch.Tensor)]
    if shapes:
        attrs["shapes"] = str(shapes)
    attrs.update({k: v for k, v in kw.items()
                  if isinstance(v, (bool, int, str))})
    _TRACER.counter("dispatch_count", "kernel", **{op: float(count)})
    with _TRACER.span(f"dispatch/{op}", "kernel", device=args[0].device,
                      **attrs):
        return impl.fn(*args, **kw)


def impls_for_layout(op: str, layout: str) -> list[str]:
    """Implementation names of `op` that take `layout`'s arrays."""
    return sorted(name for name, impl in implementations(op).items()
                  if layout in impl.layouts)


def call_stats() -> dict[str, int]:
    """Per-op dispatch counts since the last `reset_call_stats`."""
    with _CALL_STATS_LOCK:
        return dict(_CALL_STATS)


def reset_call_stats() -> None:
    with _CALL_STATS_LOCK:
        _CALL_STATS.clear()


def table() -> list[dict[str, str]]:
    """One row per (op, implementation), sorted: the introspection
    surface for docs and tests."""
    return [{"op": op, "impl": name, "family": impl.family,
             "dtypes": "/".join(impl.dtypes),
             "devices": "/".join(impl.devices),
             "layouts": "/".join(impl.layouts),
             "constraints": impl.constraints}
            for op in ops()
            for name, impl in sorted(_REGISTRY[op].items())]


def format_table() -> str:
    """`table()` as a markdown table, with this process's `call_stats()`
    total for each row's op (`launch.serve --show-kernels` prints it).
    The JAX package's `verified` column, the contract checker's verdict,
    waits for the port's checker (ROADMAP A10)."""
    stats = call_stats()
    rows = table()
    for r in rows:
        r["dispatch_count"] = str(stats.get(r["op"], 0))
    cols = ("op", "impl", "family", "dtypes", "devices", "layouts",
            "dispatch_count", "constraints")
    widths = {c: max(len(c), *(len(r[c]) for r in rows)) for c in cols}

    def line(vals):
        return "| " + " | ".join(v.ljust(widths[c])
                                 for c, v in zip(cols, vals)) + " |"
    out = [line(cols),
           "|" + "|".join("-" * (widths[c] + 2) for c in cols) + "|"]
    out += [line([r[c] for c in cols]) for r in rows]
    return "\n".join(out)
