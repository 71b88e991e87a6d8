"""Span tracer with Chrome-trace-event export.

The port's counterpart of `src/repro/obs/trace.py`: the same tracer,
event kinds, span taxonomy and Chrome JSON, plus one mechanism for the
card.  Load `export_chrome(path)` output in Perfetto
(https://ui.perfetto.dev) or chrome://tracing to read the timeline.

Design constraints, in priority order:

1. **Near-zero overhead when disabled.**  Tracing defaults OFF, and
   every hot site guards with `if TRACER.enabled:` (one attribute load
   and a bool test) before building any span arguments.  `span()`
   returns a shared no-op context manager while disabled, so even
   unguarded call sites allocate nothing.
2. **No synchronization on the hot path.**  A span over work on the card
   (`span(..., device=<cuda device>)`) records a CUDA event at its start
   and end on the current stream.  The events are read only by
   `events()` / `export_chrome()`, after one `torch.cuda.synchronize`,
   and become the span's `device_ms` attribute; the span's own `ts` /
   `dur` stay on the host clock (when the host issued the work).
3. **Thread-safe, bounded memory.**  Events land in a
   `collections.deque(maxlen=capacity)` ring: appends are atomic under
   the GIL, eviction is FIFO and counted.
4. **Monotonic clocks.**  Host timestamps are `time.perf_counter_ns`
   relative to the tracer's epoch.

Event kinds (Chrome trace `ph` values the exporter emits):

  span     `ph="X"` complete event: name, category, ts, dur, args
  instant  `ph="i"` instant event, e.g. a Predictor's first call
  counter  `ph="C"` counter event, e.g. dispatch totals over time
  (plus `ph="M"` thread-name rows, emitted at export time)

Span taxonomy:

  dispatch/<op>      kernel registry dispatch (op, impl, layout, dtype,
                     shapes; the CUDA wrapper's plan: route and blocks;
                     device_ms on the card)
  compile/<entry>    a Predictor entry's first call at a batch shape
                     (entry, layout, batch rows)
  bulk/quantize      BulkScorer binarize of a chunk (prefetch worker)
  bulk/score         BulkScorer chunk dispatch (main thread)
  bulk/sink          BulkScorer sink write of a chunk
  train/level        GBDTTrainer histogram + split pass of one level
  train/iteration    GBDTTrainer whole boosting iteration
  serve/batch        GBDTServer scored batch (batcher thread)
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import threading
import time
from typing import Any, Optional

import torch

DEFAULT_CAPACITY = 65536
_PENDING = "_cuda_events"     # args key of a span's unread CUDA events


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled:
    entering and exiting allocate nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        """Attribute updates on a disabled span are dropped."""


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span: records ts (and a CUDA event) on __enter__, appends
    on __exit__."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_stream",
                 "_start")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict[str, Any], stream):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0
        self._stream = stream
        self._start = None

    def __enter__(self) -> "_Span":
        self._tracer._open(self)
        if self._stream is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter_ns()
        if self._stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            self.args[_PENDING] = (self._start, end)
        self._tracer._close(self)
        self._tracer._append(("X", self.name, self.cat, self._t0,
                              t1 - self._t0, threading.get_ident(),
                              self.args))
        return False

    def set(self, **attrs: Any) -> None:
        """Attach attributes discovered mid-span (e.g. a kernel's plan)."""
        self.args.update(attrs)


def _cuda_stream(device) -> Optional[Any]:
    """The current stream of `device` when it is a CUDA device."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_stream(device)


class Tracer:
    """Thread-safe span/instant/counter recorder with a bounded ring.

    One process-wide instance (`get_tracer()`) serves every
    instrumentation site; tests may construct private tracers.  The
    scorer's prefetch worker and the serving batcher thread record into
    the same ring as the main thread, which is what makes prefetch
    overlap visible on the exported timeline."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = False
        # (ph, name, cat, t_ns, dur_ns, thread_ident, args) tuples
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._epoch_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._dropped = 0
        # thread ident -> name, captured at record time: a worker may be
        # gone by export time, when threading.enumerate() cannot name it
        self._thread_names: dict[int, str] = {}
        self._local = threading.local()     # this thread's open spans

    # -- control -----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._ring.clear()
        self._epoch_ns = time.perf_counter_ns()
        self._dropped = 0

    # -- recording ---------------------------------------------------------
    def _append(self, event: tuple) -> None:
        if len(self._ring) == self.capacity:
            self._dropped += 1      # racy, advisory; the ring evicts right
        if event[5] not in self._thread_names:
            self._thread_names[event[5]] = threading.current_thread().name
        self._ring.append(event)

    def _open(self, sp: _Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(sp)

    def _close(self, sp: _Span) -> None:
        stack = self._local.stack
        if stack and stack[-1] is sp:
            stack.pop()

    def span(self, name: str, cat: str = "", *, device=None, **attrs: Any):
        """Context manager timing a region.  Returns the shared no-op
        singleton while disabled.  With a CUDA `device` the span also
        records CUDA events on that device's current stream, read as
        `device_ms` at export."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, attrs, _cuda_stream(device))

    def annotate(self, **attrs: Any) -> None:
        """Attach attributes to the innermost span open on this thread
        (a kernel wrapper's plan, inside its `dispatch/<op>` span)."""
        if not self.enabled:
            return
        stack = getattr(self._local, "stack", None)
        if stack:
            stack[-1].args.update(attrs)

    def complete(self, name: str, cat: str = "", *, start_ns: int,
                 duration_ns: int, **attrs: Any) -> None:
        """Record an already-timed region as a complete span: `start_ns`
        is a `time.perf_counter_ns()` reading, the clock spans use."""
        if not self.enabled:
            return
        self._append(("X", name, cat, start_ns, duration_ns,
                      threading.get_ident(), attrs))

    def instant(self, name: str, cat: str = "", **attrs: Any) -> None:
        """A point-in-time event (Chrome `ph="i"`)."""
        if not self.enabled:
            return
        self._append(("i", name, cat, time.perf_counter_ns(), 0,
                      threading.get_ident(), attrs))

    def counter(self, name: str, cat: str = "", **values: float) -> None:
        """A process-level counter sample (Chrome `ph="C"`)."""
        if not self.enabled:
            return
        self._append(("C", name, cat, time.perf_counter_ns(), 0,
                      threading.get_ident(), values))

    # -- reading -----------------------------------------------------------
    def _resolved(self) -> tuple[list, int, int, dict[int, str]]:
        """The ring, its epoch, drop count and thread names, with every
        span's CUDA events read into `device_ms` (one synchronize, and
        only when some span still holds events)."""
        with self._lock:
            events = list(self._ring)
            pending = [args for *_, args in events if _PENDING in args]
            if pending:
                torch.cuda.synchronize()
                for args in pending:
                    start, end = args.pop(_PENDING)
                    args["device_ms"] = start.elapsed_time(end)
            return events, self._epoch_ns, self._dropped, \
                dict(self._thread_names)

    def events(self) -> list[dict[str, Any]]:
        """Snapshot of the ring as dicts (oldest first).  Timestamps are
        microseconds relative to the tracer epoch."""
        events, epoch, _, _ = self._resolved()
        return [{"ph": ph, "name": name, "cat": cat,
                 "ts_us": (t_ns - epoch) / 1e3, "dur_us": dur_ns / 1e3,
                 "tid": tid, "args": dict(args)}
                for ph, name, cat, t_ns, dur_ns, tid, args in events]

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound (advisory count)."""
        return self._dropped

    # -- export ------------------------------------------------------------
    def export_chrome(self, path: str | pathlib.Path) -> dict[str, Any]:
        """Write the ring as Chrome trace-event JSON and return the
        object: spans are `ph="X"` complete events with microsecond
        `ts` / `dur`, counters `ph="C"`, and thread-name rows label the
        prefetch and batcher threads."""
        events, epoch, dropped, names = self._resolved()
        pid = 1
        tid_map: dict[int, int] = {}
        rows: list[dict[str, Any]] = []
        main_ident = threading.main_thread().ident
        for ph, name, cat, t_ns, dur_ns, tid, args in events:
            if tid not in tid_map:
                tid_map[tid] = len(tid_map)
                label = ("main" if tid == main_ident
                         else names.get(tid, f"thread-{len(tid_map)}"))
                rows.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": tid_map[tid],
                             "args": {"name": label}})
            row: dict[str, Any] = {
                "ph": ph, "name": name, "cat": cat or "repro",
                "ts": (t_ns - epoch) / 1e3, "pid": pid,
                "tid": tid_map[tid], "args": dict(args),
            }
            if ph == "X":
                row["dur"] = dur_ns / 1e3
            elif ph == "i":
                row["s"] = "t"           # instant scope: thread
            rows.append(row)
        obj = {"traceEvents": rows, "displayTimeUnit": "ms",
               "otherData": {"dropped_events": dropped,
                             "capacity": self.capacity}}
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(obj))
        return obj


def plan_attrs(plan: Any, prefix: str = "") -> dict[str, Any]:
    """A launch plan's fields as span attributes: ints, strings and
    bools, nested plans flattened with their field name as a prefix."""
    out: dict[str, Any] = {}
    for field in dataclasses.fields(plan):
        value = getattr(plan, field.name)
        if dataclasses.is_dataclass(value):
            out.update(plan_attrs(value, f"{prefix}{field.name}_"))
        elif isinstance(value, (bool, int, str)):
            out[prefix + field.name] = value
    return out


# --------------------------------------------------------------------------
# Process-wide tracer + module-level conveniences
# --------------------------------------------------------------------------
_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer every instrumentation site records to."""
    return _GLOBAL


def enabled() -> bool:
    return _GLOBAL.enabled


def enable() -> None:
    _GLOBAL.enable()


def disable() -> None:
    _GLOBAL.disable()


def span(name: str, cat: str = "", *, device=None, **attrs: Any):
    return _GLOBAL.span(name, cat, device=device, **attrs)


def instant(name: str, cat: str = "", **attrs: Any) -> None:
    _GLOBAL.instant(name, cat, **attrs)


def counter(name: str, cat: str = "", **values: float) -> None:
    _GLOBAL.counter(name, cat, **values)


def export_chrome(path: str | pathlib.Path) -> dict[str, Any]:
    return _GLOBAL.export_chrome(path)


class tracing:
    """`with tracing():` enables the global tracer for a region and
    restores the previous state on exit (what `--trace-out` uses)."""

    def __init__(self, tracer: Optional[Tracer] = None,
                 clear: bool = False):
        # explicit None test: an empty Tracer is falsy (__len__ == 0)
        self._tracer = tracer if tracer is not None else _GLOBAL
        self._clear = clear
        self._was = False

    def __enter__(self) -> Tracer:
        if self._clear:
            self._tracer.clear()
        self._was = self._tracer.enabled
        self._tracer.enable()
        return self._tracer

    def __exit__(self, *exc: Any) -> bool:
        self._tracer.enabled = self._was
        return False
