"""Telemetry of the port: dispatch-level tracing and metrics export.

The port's counterpart of `src/repro/obs/`:

* `repro_torch.obs.trace`: a thread-safe span tracer, near zero cost
  while disabled, with a Chrome-trace-event exporter (Perfetto or
  chrome://tracing).  The hot paths are instrumented: kernel-registry
  dispatches (with the CUDA wrappers' plans and, on the card, device
  times from CUDA events read at export), Predictor first calls,
  BulkScorer quantize / score / sink stages (prefetch overlap visible on
  the timeline), training levels and iterations, served batches.
* `repro_torch.obs.hub`: a `MetricsHub` that registers the port's
  `ServerMetrics` / `ScoringMetrics` / `TrainingMetrics` snapshots
  behind one namespace and exports Prometheus-textfile and JSON.
"""
from repro_torch.obs.trace import (Tracer, get_tracer, span, instant,
                                   counter, enable, disable, enabled,
                                   export_chrome)   # noqa: F401
from repro_torch.obs.hub import MetricsHub          # noqa: F401
