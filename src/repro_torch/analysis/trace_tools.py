"""Abstract traces of PyTorch code: what the lint passes read.

The port's counterpart of `src/repro/analysis/jaxpr_tools.py`.  Where the
JAX package reads `jax.make_jaxpr`, the port runs the code under
`FakeTensorMode` (tensors with a dtype, a shape and a device, and no data:
nothing is computed, nothing is compiled) and records:

  * every aten op the code dispatches (`_OpRecorder`, a
    `TorchDispatchMode` inside the fake mode): its name, and its input and
    output tensors as values (`Value`: dtype, shape, device) numbered in
    order of appearance.  An in-place op gives its tensor a new value, so
    the events read as single assignments;
  * every kernel launch, bind and tensor check the CUDA wrappers make
    (`kernels._build.recording_launches`), in the same stream of events,
    with the tensors it passes as values of the same numbering.  Nothing
    is launched and the kernel library is never loaded.

Fake CUDA tensors need no card, with exceptions that a `TorchFunctionMode`
(`_FakeDeviceMode`) takes care of: Python indexing of a tensor on a
device PyTorch was not built for (`x[:, 1]`, `x[None]`), `copy_` and
`contiguous` ask that device's runtime for a guard, so they are spelled
as the aten ops they stand for; `data_ptr()` of a fake tensor is 0 (a
16-byte aligned address, as the caching allocator gives); `numpy()` of a
fake tensor is zeros of its shape and dtype (the plain split search adds
its float32 chains with numpy on the CPU, `core.split_sums`), and what is
made from that array joins the trace as a constant.  A `.item()` (an aten
`_local_scalar_dense`) is recorded and answered with 0: under the fake
mode it has no value, and the `transfer` lint flags it.

`terminal_consumers` follows a value through view and move ops to the
events that use it, as the JAX walker follows a var through
transpose/reshape.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _build, ops, registry


# --------------------------------------------------------------------------
# Values and events
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Value:
    """One tensor value of a trace."""
    vid: int
    dtype: torch.dtype
    shape: tuple[int, ...]
    device: torch.device

    def short(self) -> str:
        return (f"{dtype_name(self.dtype)}"
                f"[{','.join(str(d) for d in self.shape)}]")


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Event:
    """One recorded step: an aten op ("op", `name` the op's packet name,
    e.g. "_to_copy", "index_select", "add_"), or a `kernels._build`
    record ("launch", "bind" or "check", `name` the launcher or the
    checked op).  `inputs` are (position, value id) pairs, the position
    the argument's index (a list argument gives each of its tensors the
    list's index; a keyword, its name); `outputs` value ids.  `record` is
    the launch record; `kwargs` the op's non-tensor keywords."""
    kind: str
    name: str
    inputs: tuple[tuple[Any, int], ...]
    outputs: tuple[int, ...]
    kwargs: tuple[tuple[str, Any], ...] = ()
    record: Optional[_build.LaunchRecord] = None


@dataclasses.dataclass
class Trace:
    """The events of one abstract run, its values, and which values were
    the call's arguments (`inputs`) and result (`outputs`)."""
    events: list[Event] = dataclasses.field(default_factory=list)
    values: dict[int, Value] = dataclasses.field(default_factory=dict)
    inputs: tuple[int, ...] = ()
    outputs: tuple[int, ...] = ()

    def launches(self) -> list[Event]:
        return [e for e in self.events if e.kind == "launch"]

    def ops(self, *names: str) -> list[Event]:
        return [e for e in self.events
                if e.kind == "op" and (not names or e.name in names)]

    def launch_signature(self) -> tuple:
        """The launches as (launcher, device, arguments): what a plan
        change shows as."""
        return tuple((e.record.name, str(e.record.device),
                      tuple(str(a) for a in e.record.args))
                     for e in self.launches())


# Ops that only view, reshape or move a value: the widening walk follows a
# value through them to the events that use it.
VIEW_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
    "transpose", "t", "expand", "select", "slice", "narrow", "clone",
    "contiguous", "squeeze", "unsqueeze", "alias", "detach", "as_strided",
    "lift_fresh", "lift_fresh_copy",
})


def is_move(event: Event, values: dict[int, Value]) -> bool:
    """A view op, or a `_to_copy` / `copy_` that keeps the dtype (a device
    move or a plain copy)."""
    if event.kind != "op":
        return False
    if event.name in VIEW_OPS:
        return True
    if event.name in ("_to_copy", "copy_") and event.outputs:
        src = [v for p, v in event.inputs if p == (0 if event.name ==
                                                   "_to_copy" else 1)]
        return bool(src) and values[src[0]].dtype == \
            values[event.outputs[0]].dtype
    return False


def consumers_map(trace: Trace) -> dict[int, list[tuple[int, Any]]]:
    """value id -> [(event index, position)] of the events reading it."""
    out: dict[int, list[tuple[int, Any]]] = {}
    for i, e in enumerate(trace.events):
        for pos, vid in e.inputs:
            out.setdefault(vid, []).append((i, pos))
    return out


def moved_source(event: Event) -> Any:
    """The argument position a move carries along (copy_'s source)."""
    return 1 if event.name == "copy_" else 0


def terminal_consumers(trace: Trace, start: int,
                       consumers: Optional[dict] = None
                       ) -> list[tuple[Event, Any]]:
    """(event, position) pairs that use (not merely move) the value
    `start`: follows the outputs of view and move ops (`is_move`)
    transitively.  A value that no event reads is not reported."""
    cmap = consumers if consumers is not None else consumers_map(trace)
    out: list[tuple[Event, Any]] = []
    seen: set[tuple[int, Any]] = set()
    stack = [start]
    while stack:
        vid = stack.pop()
        for i, pos in cmap.get(vid, ()):
            if (i, pos) in seen:
                continue
            seen.add((i, pos))
            e = trace.events[i]
            if is_move(e, trace.values) and pos == moved_source(e):
                stack.extend(e.outputs)
            else:
                out.append((e, pos))
    return out


def views_of(trace: Trace, start: int) -> set[int]:
    """`start` and every value made from it by view ops alone."""
    cmap = consumers_map(trace)
    out, stack = {start}, [start]
    while stack:
        for i, pos in cmap.get(stack.pop(), ()):
            e = trace.events[i]
            if e.kind == "op" and e.name in VIEW_OPS and pos == 0:
                for v in e.outputs:
                    if v not in out:
                        out.add(v)
                        stack.append(v)
    return out


# --------------------------------------------------------------------------
# Recording
# --------------------------------------------------------------------------
class _Numbering:
    """Tensor object -> current value id.  Keeps every tensor it has seen
    alive for the trace's lifetime, so no id() is reused."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self.ids: dict[int, int] = {}
        self.keep: list[torch.Tensor] = []

    def _new(self, t: torch.Tensor) -> int:
        vid = len(self.trace.values)
        self.trace.values[vid] = Value(vid, t.dtype, tuple(int(d) for d in
                                                           t.shape),
                                       t.device)
        self.ids[id(t)] = vid
        self.keep.append(t)
        return vid

    def read(self, t: torch.Tensor) -> int:
        vid = self.ids.get(id(t))
        return self._new(t) if vid is None else vid

    def write(self, t: torch.Tensor) -> int:
        return self._new(t)


def _tensor_inputs(numbering: _Numbering, args, kwargs
                   ) -> tuple[tuple[Any, int], ...]:
    out = []
    for pos, a in list(enumerate(args)) + list(kwargs.items()):
        leaves, _ = tree_flatten(a)
        out += [(pos, numbering.read(t)) for t in leaves
                if isinstance(t, torch.Tensor)]
    return tuple(out)


_PLACEHOLDER = {torch.bool: False}


class _OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched inside it into a trace."""

    def __init__(self, numbering: _Numbering):
        super().__init__()
        self.numbering = numbering

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":          # prim.device and kin
            return func(*args, **kwargs)
        name = func.overloadpacket.__name__
        inputs = _tensor_inputs(self.numbering, args, kwargs)
        extra = tuple((k, v) for k, v in sorted(kwargs.items())
                      if not isinstance(v, torch.Tensor))
        if name == "_local_scalar_dense":
            self.numbering.trace.events.append(
                Event("op", name, inputs, (), extra))
            t = args[0]
            return _PLACEHOLDER.get(t.dtype, 0.0 if t.is_floating_point()
                                    else 0)
        out = func(*args, **kwargs)
        leaves, _ = tree_flatten(out)
        outputs = tuple(self.numbering.write(t) for t in leaves
                        if isinstance(t, torch.Tensor))
        self.numbering.trace.events.append(
            Event("op", name, inputs, outputs, extra))
        return out


def _index_parts(x: torch.Tensor, index) -> list:
    index = index if isinstance(index, tuple) else (index,)
    n_real = sum(1 for i in index if i is not None and i is not Ellipsis
                 and not (isinstance(i, torch.Tensor) and i.dtype ==
                          torch.bool))
    n_real += sum(i.ndim for i in index if isinstance(i, torch.Tensor)
                  and i.dtype == torch.bool)
    out = []
    for i in index:
        if i is Ellipsis:
            out += [slice(None)] * (x.ndim - n_real)
        else:
            out.append(i)
    return out


def _basic_view(x: torch.Tensor, parts: list
                ) -> tuple[torch.Tensor, list[tuple[int, torch.Tensor]]]:
    """x viewed through the int, slice and None parts of an index, and the
    tensor parts left over as (dim of the view, index tensor)."""
    dim, tensors = 0, []
    for p in parts:
        if p is None:
            x = x.unsqueeze(dim)
            dim += 1
        elif isinstance(p, bool):
            raise TypeError("bool indexing is not taken here")
        elif isinstance(p, int):
            x = x.select(dim, p)
        elif isinstance(p, slice):
            start, stop, step = p.indices(x.shape[dim])
            x = torch.ops.aten.slice.Tensor(x, dim, start, stop, step)
            dim += 1
        elif isinstance(p, torch.Tensor):
            tensors.append((dim, p))
            dim += 1
        else:
            raise TypeError(f"index part {p!r} is not taken here")
    return x, tensors


def _getitem(x: torch.Tensor, index) -> torch.Tensor:
    view, tensors = _basic_view(x, _index_parts(x, index))
    if not tensors:
        return view
    indices: list = [None] * view.ndim
    for dim, t in tensors:
        indices[dim] = t
    while indices and indices[-1] is None:
        indices.pop()
    return torch.ops.aten.index.Tensor(view, indices)


def _setitem(x: torch.Tensor, index, value) -> None:
    view, tensors = _basic_view(x, _index_parts(x, index))
    if not tensors:
        if isinstance(value, torch.Tensor):
            torch.ops.aten.copy_.default(view, value)
        else:
            torch.ops.aten.fill_.Scalar(view, value)
        return
    indices: list = [None] * view.ndim
    for dim, t in tensors:
        indices[dim] = t
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=x.dtype, device=x.device)
    torch.ops.aten.index_put_(view, indices, value)


def _contiguous(x: torch.Tensor, memory_format=torch.contiguous_format
                ) -> torch.Tensor:
    if x.is_contiguous(memory_format=memory_format):
        return x
    return torch.ops.aten.clone.default(x, memory_format=memory_format)


def _copy_(x: torch.Tensor, src, non_blocking: bool = False
           ) -> torch.Tensor:
    return torch.ops.aten.copy_.default(x, src, non_blocking)


# Tensor methods whose Python binding takes a device guard before it
# dispatches, and the aten op each stands for.
_GUARDED = {torch.Tensor.contiguous: _contiguous,
            torch.Tensor.copy_: _copy_}


class _FakeDeviceMode(TorchFunctionMode):
    """Indexing of tensors off the CPU spelled as aten view ops,
    `data_ptr()` of fake tensors as 0 and their `numpy()` as zeros (see
    the module docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__ and \
                args[0].device.type != "cpu":
            return _getitem(*args)
        if func is torch.Tensor.__setitem__ and \
                args[0].device.type != "cpu":
            return _setitem(*args)
        if func is torch.Tensor.data_ptr and _is_fake(args[0]):
            return 0
        if func is torch.Tensor.numpy and _is_fake(args[0]):
            return np.zeros(tuple(args[0].shape),
                            dtype=dtype_name(args[0].dtype))
        if func in _GUARDED and args[0].device.type != "cpu":
            return _GUARDED[func](*args, **kwargs)
        return func(*args, **kwargs)


def _is_fake(t: Any) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def fake_mode_of(*tensors: Any):
    """The FakeTensorMode the first fake tensor among `tensors` belongs to,
    or None."""
    for t in tensors:
        if _is_fake(t):
            return t.fake_mode
    return None


def new_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


_CARDLESS = threading.Lock()


@contextlib.contextmanager
def cardless_devices():
    """Let fake tensors name CUDA devices the machine does not have.  A
    fake CUDA tensor first makes a real tensor on its device where CUDA is
    available (`fake_tensor.init_gpu_context`); a mesh of four fake cards
    walked on a one-card machine must not, so devices past the card count
    skip it."""
    from torch._subclasses import fake_tensor as ft
    with _CARDLESS:
        original = ft.init_gpu_context
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0

        def init(device: torch.device) -> None:
            if device.type == "cuda" and (device.index or 0) >= count:
                return
            original(device)
        ft.init_gpu_context = init
        try:
            yield
        finally:
            ft.init_gpu_context = original


@contextlib.contextmanager
def counts_kept() -> Iterator[None]:
    """Leave the wrappers' launch counts and the registry's dispatch
    counts as they were: a recorded launch launches nothing, and a walk
    is no dispatch a user made."""
    launches, calls = ops.launch_counts(), registry.call_stats()
    try:
        yield
    finally:
        for name, fn in ops.KERNELS.items():
            fn.launches = launches[name]
        registry.reset_call_stats(calls)


@contextlib.contextmanager
def recording(mode=None) -> Iterator[Trace]:
    """Record into a fresh `Trace` every op and launch made inside the
    block, under `mode` (a FakeTensorMode; a new one when None).  Tensors
    made inside are fake; real tensors passed in are read as constants.
    Kernel launches are recorded, never made."""
    trace = Trace()
    numbering = _Numbering(trace)

    def on_record(rec: _build.LaunchRecord) -> None:
        if rec.kind == "check":
            pos = [name for name, _ in rec.args]
        else:
            pos = [i for i, _ in rec.tensor_args()]
        inputs = tuple((p, numbering.read(t))
                       for p, t in zip(pos, rec.tensors))
        trace.events.append(Event(rec.kind, rec.name, inputs, (),
                                  record=rec))

    mode = mode if mode is not None else new_fake_mode()
    with counts_kept(), cardless_devices(), mode, _FakeDeviceMode(), \
            _OpRecorder(numbering), \
            _build.recording_launches(sink=on_record):
        trace._numbering = numbering
        yield trace
    del trace._numbering


def mark_io(trace: Trace, inputs: Sequence[torch.Tensor],
            outputs: Any) -> None:
    """Note which values were the call's arguments and its result."""
    numbering = trace._numbering
    trace.inputs = tuple(numbering.read(t) for t in inputs
                         if isinstance(t, torch.Tensor))
    leaves, _ = tree_flatten(outputs)
    trace.outputs = tuple(numbering.read(t) for t in leaves
                          if isinstance(t, torch.Tensor))


@dataclasses.dataclass(frozen=True)
class Spec:
    """An argument of an abstract call: shape, dtype and device (the
    port's `jax.ShapeDtypeStruct`)."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    device: str = "cpu"

    def short(self) -> str:
        return (f"{dtype_name(self.dtype)}"
                f"[{','.join(str(d) for d in self.shape)}]@{self.device}")


def trace_abstract(fn: Callable, *specs: Any, **kwargs: Any) -> Trace:
    """Run `fn` on fake tensors of `specs` (Spec; anything else is passed
    as it is) and record it: the port's `jax.make_jaxpr`.  kwargs are
    passed through (the static arguments of the registry's functions)."""
    with recording() as trace:
        args = [torch.empty(s.shape, dtype=s.dtype, device=s.device)
                if isinstance(s, Spec) else s for s in specs]
        out = fn(*args, **kwargs)
        mark_io(trace, args, out)
    return trace
