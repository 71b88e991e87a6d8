"""Serving launcher: batched GBDT scoring through a `ModelRegistry`.

The port's counterpart of `src/repro/launch/serve.py`, on the card unless
``--device cpu``:

  python -m repro_torch.launch.serve --mode gbdt --multi 3
  python -m repro_torch.launch.serve --show-kernels

`--mode lm` (LM generation) waits for the port's LM scaffold (ROADMAP
A11), the tracing flags for its telemetry (A8).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def serve_gbdt(args) -> None:
    from repro_torch.core import boosting, losses
    from repro_torch.core.boosting import BoostingParams
    from repro_torch.core.predictor import PredictConfig
    from repro_torch.data import synthetic
    from repro_torch.serving.engine import ModelRegistry

    ds = synthetic.load(args.dataset, scale=args.scale)
    loss = losses.make_loss(ds.loss, n_classes=max(ds.n_classes, 2),
                            group_index=ds.group_index_train)
    ens, _ = boosting.fit(ds.x_train, ds.y_train, loss=loss,
                          params=BoostingParams(
                              n_trees=args.trees, depth=ds.params.depth,
                              learning_rate=0.1),
                          device=args.device, backend=args.backend)
    # One PredictConfig for the registry; each server builds its plan
    # from it at registration (auto resolved there).
    config = PredictConfig(strategy=args.strategy, backend=args.backend,
                           layout=args.layout, tree_block=args.tree_block)
    registry = ModelRegistry(max_batch=args.batch, config=config,
                             device=args.device,
                             min_bucket=args.min_bucket,
                             deadline_ms=args.deadline_ms or None)
    try:
        server = registry.register(args.dataset, ens)
        # K tree-slice variants of the model share its quantization
        # schema, so predict_multi binarizes each batch once for all of
        # them (at most one variant per tree)
        n_variants = min(args.multi, ens.n_trees)
        per = max(1, ens.n_trees // n_variants)
        for i in range(1, n_variants):
            registry.register(f"{args.dataset}-v{i}", ens.slice_trees(
                i * per, min((i + 1) * per, ens.n_trees)))
        stats = server.predictor.stats
        print(f"[serve:gbdt] model={args.dataset} plan={server.config} "
              f"device={server.predictor.device} buckets={server.buckets} "
              f"schema={server.schema_fingerprint}")
        print(f"[serve:gbdt] layout={stats['layout']} "
              f"lowered in {stats['lower_time_s'] * 1e3:.1f}ms")
        t0 = time.perf_counter()
        n = 200
        for i in range(n):
            registry.predict(args.dataset, ds.x_test[i % len(ds.x_test)])
        dt = time.perf_counter() - t0
        print(f"[serve:gbdt] {n} sequential requests in {dt:.2f}s; "
              f"batches={len(server.batcher.batch_sizes)}")
        if args.multi > 1:
            xs = ds.x_test[:min(len(ds.x_test), args.batch)]
            t0 = time.perf_counter()
            out = registry.predict_multi(xs)
            dt = time.perf_counter() - t0
            print(f"[serve:gbdt] predict_multi({len(xs)} rows x "
                  f"{len(out)} models, quantize-once) in {dt * 1e3:.1f}ms")
        print(f"[serve:gbdt] metrics: "
              f"{json.dumps(registry.metrics()[args.dataset], default=float)}")
    finally:
        registry.close()


def show_kernels(args) -> None:
    """The kernel registry and layout tables, and the layout this process
    would resolve for `--layout`."""
    import torch

    from repro_torch.core import layout as layout_mod
    from repro_torch.kernels import registry as kernel_registry
    from repro_torch.kernels import tuning

    print(kernel_registry.format_table())
    print("\nverified: the contract checker is not ported yet (ROADMAP A10)")
    print()
    print(layout_mod.format_layout_table())
    if args.layout != "auto":
        print(f"\nresolved layout: {args.layout} (pinned by --layout)")
        return
    # auto shown against three canned depth histograms, since no model is
    # trained under --show-kernels
    device = torch.device(args.device)
    uniform = tuning.best_layout(np.full(100, 6), 1, 54, device=device)
    mixed = tuning.best_layout(np.tile([2, 3, 4, 6], 25), 1, 54,
                               device=device)
    huge = tuning.best_layout(np.tile([4, 6, 8, 10], 50_000), 1, 512,
                              device=device)
    print(f"\nresolved layout (auto, on {device.type}): uniform-depth -> "
          f"{uniform}, mixed-depth -> {mixed}, huge-mixed -> {huge}")


def parse_args(argv=None):
    from repro_torch.core.layout import LAYOUT_NAMES
    from repro_torch.kernels import registry

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--mode", choices=["gbdt", "lm"], default="gbdt")
    ap.add_argument("--dataset", default="santander")
    ap.add_argument("--scale", type=float, default=0.004)
    ap.add_argument("--trees", type=int, default=100)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--strategy", choices=["auto", "staged", "fused"],
                    default="auto")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", *registry.known_backends()])
    ap.add_argument("--layout", default="auto",
                    choices=["auto", *LAYOUT_NAMES],
                    help="physical model layout the plan lowers to "
                         "(auto = kernels.tuning.best_layout: soa on the "
                         "card)")
    ap.add_argument("--tree-block", type=int, default=0,
                    help="staged-path tree block (0 = whole ensemble)")
    ap.add_argument("--min-bucket", type=int, default=16,
                    help="smallest batch-size padding bucket")
    ap.add_argument("--multi", type=int, default=1,
                    help="register K schema-sharing model variants and "
                         "demo the quantize-once predict_multi path")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="arm per-batch deadline-SLO accounting at this "
                         "latency (0 = off)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains and serves (the card by "
                         "default)")
    ap.add_argument("--show-kernels", action="store_true",
                    help="print the kernel registry table and exit")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.show_kernels:
        show_kernels(args)
        return 0
    if args.mode == "lm":
        print("--mode lm needs the LM scaffold, which the port does not "
              "have yet (ROADMAP A11)", file=sys.stderr)
        return 2
    serve_gbdt(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
