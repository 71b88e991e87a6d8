"""Shared `--trace-out` / `--metrics-out` wiring for the launchers.

The port's counterpart of `src/repro/launch/obs_cli.py`: every job CLI
(serve, score, train_gbdt) exposes the same two flags:

  --trace-out FILE    enable the global span tracer for the run and
                      export Chrome trace-event JSON on exit (load the
                      file in https://ui.perfetto.dev or
                      chrome://tracing)
  --metrics-out FILE  export the job's metrics snapshots through a
                      `MetricsHub`: `.prom` suffix writes the
                      Prometheus textfile format, anything else JSON

The helpers keep flag names, export-format selection, and the
enable/export/disable lifecycle identical across launchers.  On the card
the export reads every span's CUDA events after one synchronization.
"""
from __future__ import annotations

import sys
from typing import Any, Mapping


def add_obs_flags(ap) -> None:
    ap.add_argument("--trace-out", default="",
                    help="trace the run and write Chrome trace-event "
                         "JSON here (Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default="",
                    help="write a MetricsHub export here (.prom = "
                         "Prometheus textfile, else JSON)")


def start_tracing(args) -> bool:
    """Enable the global tracer when --trace-out was passed.  Returns
    whether tracing is on (callers need no tracer handle: export goes
    through `finish_obs`)."""
    if not getattr(args, "trace_out", ""):
        return False
    from repro_torch.obs.trace import get_tracer
    tracer = get_tracer()
    tracer.clear()
    tracer.enable()
    return True


def finish_obs(args, metrics_sources: Mapping[str, Any] | None = None
               ) -> None:
    """Export whatever --trace-out / --metrics-out asked for.

    `metrics_sources` maps hub namespaces to snapshot sources (any
    form `MetricsHub.register` accepts: metrics objects, callables,
    plain dicts)."""
    if getattr(args, "trace_out", ""):
        from repro_torch.obs.trace import get_tracer
        tracer = get_tracer()
        obj = tracer.export_chrome(args.trace_out)
        tracer.disable()
        n = sum(1 for r in obj["traceEvents"] if r["ph"] != "M")
        print(f"[obs] {n} trace events -> {args.trace_out} "
              f"(dropped={obj['otherData']['dropped_events']})",
              file=sys.stderr)
    if getattr(args, "metrics_out", "") and metrics_sources:
        from repro_torch.obs import MetricsHub
        hub = MetricsHub()
        for ns, src in metrics_sources.items():
            hub.register(ns, src)
        if args.metrics_out.endswith(".prom"):
            hub.export_prometheus(args.metrics_out)
        else:
            hub.export_json(args.metrics_out)
        print(f"[obs] metrics ({', '.join(hub.namespaces())}) -> "
              f"{args.metrics_out}", file=sys.stderr)
