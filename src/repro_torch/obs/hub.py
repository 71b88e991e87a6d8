"""MetricsHub: one namespace over every metrics class of the port.

The port's counterpart of `src/repro/obs/hub.py`, with the same
registration forms, failure isolation, metric names and label escaping,
so the same snapshots give the same Prometheus text from either
package.  The port has three snapshot-shaped metrics classes,
`ServerMetrics` (online serving), `ScoringMetrics` (offline bulk) and
`TrainingMetrics` (boosting), each exporting a flat dict in shared units
(`rows_per_s` appears in all three).  The hub registers any number of
them behind namespaces and renders the combined view in two formats:

* **JSON**: `{namespace: snapshot}` with a capture timestamp, what the
  launchers' `--metrics-out` writes for any suffix but `.prom`.
* **Prometheus textfile**: one gauge per numeric snapshot field,
  `repro_<namespace>_<field>`, string fields attached as labels (the
  node_exporter textfile-collector format).

Sources are anything with a `.snapshot()` method, any zero-arg callable
returning a dict, or a plain dict.
"""
from __future__ import annotations

import datetime
import json
import pathlib
import re
import threading
from typing import Any, Callable, Mapping

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(*parts: str) -> str:
    """Join parts into a Prometheus-legal metric name."""
    name = "_".join(_NAME_RE.sub("_", p) for p in parts if p)
    if not name or name[0].isdigit():
        name = "repro_" + name
    return name


def _label_value(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


class MetricsHub:
    """Named registry of snapshot sources with JSON/Prometheus export.

    >>> hub = MetricsHub()
    >>> hub.register("serving/gbdt", server.metrics)
    >>> hub.register("scoring/nightly", lambda: result.metrics)
    >>> hub.snapshot()["serving/gbdt"]["rows_per_s"]
    >>> hub.export_prometheus("metrics.prom")
    """

    def __init__(self, prefix: str = "repro"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._sources: dict[str, Callable[[], Mapping[str, Any]]] = {}

    def register(self, namespace: str, source: Any,
                 replace: bool = False) -> None:
        """Register a snapshot source under `namespace`.

        `source` is an object with `.snapshot()` (ServerMetrics,
        ScoringMetrics, TrainingMetrics), a zero-arg callable
        returning a dict, or a plain dict (captured by reference).
        Re-registering a live namespace without `replace=True` raises —
        silently shadowing a dashboard feed is the failure mode this
        guards."""
        if hasattr(source, "snapshot"):
            fn = source.snapshot
        elif callable(source):
            fn = source
        elif isinstance(source, Mapping):
            fn = lambda: source                       # noqa: E731
        else:
            raise TypeError(
                f"source for {namespace!r} must have .snapshot(), be "
                f"callable, or be a Mapping; got {type(source).__name__}")
        with self._lock:
            if namespace in self._sources and not replace:
                raise KeyError(f"namespace {namespace!r} already "
                               "registered (pass replace=True)")
            self._sources[namespace] = fn

    def unregister(self, namespace: str) -> None:
        with self._lock:
            if namespace not in self._sources:
                raise KeyError(f"unknown namespace {namespace!r}; "
                               f"registered: {self.namespaces()}")
            del self._sources[namespace]

    def namespaces(self) -> list[str]:
        with self._lock:
            return sorted(self._sources)

    # -- collection --------------------------------------------------------
    def snapshot(self) -> dict[str, dict[str, Any]]:
        """Collect every source.  A source that raises is reported as
        `{"error": repr}` instead of poisoning the whole export (a
        dead model's metrics must not take down the fleet view)."""
        with self._lock:
            sources = dict(self._sources)
        out: dict[str, dict[str, Any]] = {}
        for ns, fn in sources.items():
            try:
                out[ns] = dict(fn())
            except Exception as e:          # noqa: BLE001 — see docstring
                out[ns] = {"error": repr(e)}
        return out

    # -- export ------------------------------------------------------------
    def export_json(self, path: str | pathlib.Path) -> dict[str, Any]:
        obj = {
            "collected_at": datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds"),
            "metrics": self.snapshot(),
        }
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(obj, indent=1, default=float))
        return obj

    def format_prometheus(self) -> str:
        """Render every numeric snapshot field as a gauge in the
        Prometheus text exposition format.

        Numbers (and bools, as 0/1) become
        `<prefix>_<namespace>_<field> value`; string fields become
        labels shared by every gauge of that namespace; nested dicts
        flatten one level (`traces.raw` -> `traces_raw`); lists are
        skipped (no natural gauge shape)."""
        lines: list[str] = []
        for ns, snap in sorted(self.snapshot().items()):
            flat: dict[str, float] = {}
            labels: dict[str, str] = {}
            for key, val in snap.items():
                if isinstance(val, bool):
                    flat[key] = float(val)
                elif isinstance(val, (int, float)):
                    flat[key] = float(val)
                elif isinstance(val, str):
                    labels[key] = val
                elif isinstance(val, Mapping):
                    for k2, v2 in val.items():
                        if isinstance(v2, (int, float)) \
                                and not isinstance(v2, bool):
                            flat[f"{key}_{k2}"] = float(v2)
                        elif isinstance(v2, bool):
                            flat[f"{key}_{k2}"] = float(v2)
                # lists / None: no gauge shape, skipped
            label_str = ""
            if labels:
                label_str = "{" + ",".join(
                    f'{_metric_name(k)}="{_label_value(v)}"'
                    for k, v in sorted(labels.items())) + "}"
            for key, val in sorted(flat.items()):
                name = _metric_name(self.prefix, ns, key)
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name}{label_str} {val:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_prometheus(self, path: str | pathlib.Path) -> str:
        text = self.format_prometheus()
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        return text
