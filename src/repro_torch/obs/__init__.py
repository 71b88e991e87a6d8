"""Telemetry of the port: dispatch-level tracing and metrics export.

The port's counterpart of `src/repro/obs/`:

* `repro_torch.obs.trace`: a thread-safe span tracer, near zero cost
  while disabled, with a Chrome-trace-event exporter (Perfetto or
  chrome://tracing).  The hot paths are instrumented: kernel-registry
  dispatches (with the CUDA wrappers' plans and, on the card, device
  times from CUDA events read at export), Predictor first calls and its
  copy of host rows to the card (`plan/h2d`), BulkScorer quantize /
  score / sink stages (prefetch overlap visible on the timeline),
  training levels and iterations (device time placed at the host start),
  the trainer's host split search (`trainer/split`) and its host work
  after a tree's synchronization (`trainer/sync`), served batches.
  While enabled, every live span is also a `torch.profiler` range of the
  same name, so a profile names the program's spans in its own clock;
  `Tracer.epoch_unix_ns` places the tracer's own timestamps there.
* `repro_torch.obs.hub`: a `MetricsHub` that registers the port's
  `ServerMetrics` / `ScoringMetrics` / `TrainingMetrics` snapshots
  behind one namespace and exports Prometheus-textfile and JSON.
"""
from repro_torch.obs.trace import (Tracer, get_tracer, span, instant,
                                   counter, enable, disable, enabled,
                                   export_chrome)   # noqa: F401
from repro_torch.obs.hub import MetricsHub          # noqa: F401
