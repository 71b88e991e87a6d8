"""Bulk-scoring launcher: sweep a whole dataset through prepared plans.

The port's counterpart of `src/repro/launch/score.py`: train (or load) a
model, stream a dataset through `BulkScorer` on the card (``--device cpu``
for the plain versions), write scores or stats, print the throughput
metrics.  The paper's ApplyModelMulti dataset sweep as a CLI:

  # score synthetic covertype end-to-end, auto chunking, stats summary
  python -m repro_torch.launch.score --dataset covertype --scale 0.01

  # out-of-core: 280k virtual rows -> scores.npy memmap, 3 models
  python -m repro_torch.launch.score --dataset covertype --scale 0.05 \\
      --repeat 4 --models 3 --chunk 16384 --out /tmp/scores.npy

  # score an .npy feature matrix through a CatBoost JSON export
  python -m repro_torch.launch.score --from-npy x.npy \\
      --model-json model.json --out scores.npy

  # resume an interrupted run at chunk 12
  python -m repro_torch.launch.score ... --out scores.npy --resume-from 12

``--check`` re-scores the dataset through each plan's own `raw` / `proba`
/ `classify` entry, a step of rows at a time, and exits nonzero on any
mismatch.  ``--trace-out FILE`` writes a Chrome trace of the run (load it
in Perfetto), ``--metrics-out FILE`` the `scoring/bulk` metrics
(Prometheus text for a ``.prom`` file, JSON otherwise).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def eprint(*a):
    print(*a, file=sys.stderr, flush=True)


def _build_plans(args):
    """Train the demo model (or load a CatBoost JSON) and cut K
    schema-sharing variants: the whole model and K - 1 tree slices."""
    from repro_torch.core.predictor import PredictConfig, Predictor

    config = PredictConfig(strategy=args.strategy, backend=args.backend,
                           layout=args.layout)
    if args.model_json:
        plan = Predictor.from_catboost_json(args.model_json, config,
                                            device=args.device)
        return {"model": plan}

    from repro_torch.core import boosting, losses
    from repro_torch.core.boosting import BoostingParams
    from repro_torch.data import synthetic

    ds = synthetic.load(args.dataset, scale=args.scale)
    loss = losses.make_loss(ds.loss if ds.loss in ("multiclass", "logloss")
                            else "logloss",
                            n_classes=max(ds.n_classes, 2))
    y = ds.y_train if ds.n_classes else (ds.y_train > np.median(
        ds.y_train)).astype(np.int32)
    ens, _ = boosting.fit(ds.x_train, y, loss=loss,
                          params=BoostingParams(n_trees=args.trees,
                                                depth=ds.params.depth,
                                                learning_rate=0.1),
                          device=args.device)
    n_variants = max(1, min(args.models, ens.n_trees))
    per = max(1, ens.n_trees // n_variants)
    names = [args.dataset] + [f"{args.dataset}-v{i}"
                              for i in range(1, n_variants)]
    slices = [ens] + [ens.slice_trees(i * per, min((i + 1) * per,
                                                   ens.n_trees))
                      for i in range(1, n_variants)]
    return {name: Predictor.build(e, config, device=args.device)
            for name, e in zip(names, slices)}


def _build_source(args):
    from repro_torch.scoring import NpyMemmapSource, SyntheticSource

    if args.from_npy:
        return NpyMemmapSource(args.from_npy)
    return SyntheticSource(args.dataset, scale=args.scale,
                           split=args.split, repeat=args.repeat)


def _build_sinks(args, plans):
    from repro_torch.scoring import ArraySink, NpySink, StatsSink, TopKSink

    def one(name):
        if args.top_k:
            return TopKSink(args.top_k, column=args.top_k_column)
        if not args.out:
            return StatsSink() if args.stats_only else ArraySink()
        path = args.out if len(plans) == 1 else \
            args.out.replace(".npy", f".{name}.npy")
        return NpySink(path, resume=args.resume_from > 0)

    return {name: one(name) for name in plans}


def _check(args, plans, source, result) -> bool:
    """Re-score every plan through its own entry, `step` rows at a time
    (the check streams too), against the bulk output."""
    ok = True
    step = 4096
    for name, plan in plans.items():
        out = result.outputs[name]
        got = (np.load(out, mmap_mode="r") if not
               isinstance(out, np.ndarray) else out)
        entry = {"raw": plan.raw, "proba": plan.proba,
                 "classify": plan.classify}[args.output]
        err = 0.0
        for s in range(0, source.n_rows, step):
            stop = min(s + step, source.n_rows)
            want = entry(source.read(s, stop)).cpu().numpy() \
                .astype(np.float32)
            if want.ndim == 1:
                want = want[:, None]
            if want.size:
                err = max(err, float(np.max(
                    np.abs(np.asarray(got[s:stop]) - want))))
        eprint(f"[score] check {name}: max |err| = {err:.2e}")
        ok &= err < 1e-5
    return ok


def parse_args(argv=None):
    from repro_torch.core.layout import LAYOUT_NAMES
    from repro_torch.kernels import registry

    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="covertype",
                    help="synthetic dataset to train on / score")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--split", default="test",
                    choices=["train", "test", "all"])
    ap.add_argument("--repeat", type=int, default=1,
                    help="virtually tile the dataset k times "
                         "(out-of-core row counts at base-memory cost)")
    ap.add_argument("--from-npy", default="",
                    help="score this .npy feature matrix (memmapped) "
                         "instead of a synthetic dataset")
    ap.add_argument("--model-json", default="",
                    help="load a CatBoost JSON export instead of "
                         "training the demo model")
    ap.add_argument("--trees", type=int, default=50)
    ap.add_argument("--models", type=int, default=1,
                    help="score K schema-sharing model variants per "
                         "chunk (quantize once, score many)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="fixed chunk rows (0 = auto from "
                         "kernels.tuning.best_chunk_rows)")
    ap.add_argument("--strategy", choices=["auto", "staged", "fused"],
                    default="auto")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", *registry.known_backends()])
    ap.add_argument("--layout", default="auto",
                    choices=["auto", *LAYOUT_NAMES])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the plans run (the card by default)")
    ap.add_argument("--output", default="raw",
                    choices=["raw", "proba", "classify"])
    ap.add_argument("--no-prequantize", action="store_true",
                    help="score float chunks (binarize inside the "
                         "fused kernel) instead of pools the prefetch "
                         "worker quantized")
    ap.add_argument("--prefetch-depth", type=int, default=2)
    ap.add_argument("--out", default="",
                    help="write scores to this .npy (memmapped; "
                         "multi-model runs get .<name>.npy suffixes)")
    ap.add_argument("--stats-only", action="store_true",
                    help="stream per-column score stats instead of "
                         "keeping scores")
    ap.add_argument("--top-k", type=int, default=0,
                    help="stream the top-k rows by score instead of "
                         "keeping all scores")
    ap.add_argument("--top-k-column", type=int, default=0)
    ap.add_argument("--resume-from", type=int, default=0,
                    help="first chunk index to score (resume an "
                         "interrupted run; requires --out)")
    ap.add_argument("--check", action="store_true",
                    help="verify bulk output against each plan's own "
                         "entry; exit 1 on mismatch")
    from repro_torch.launch.obs_cli import add_obs_flags
    add_obs_flags(ap)
    args = ap.parse_args(argv)
    if sum([bool(args.out), args.stats_only, bool(args.top_k)]) > 1:
        ap.error("--out, --stats-only and --top-k pick one output mode "
                 "each; pass at most one")
    if args.resume_from and not args.out:
        ap.error("--resume-from needs --out (a row-addressed .npy the "
                 "resumed chunks land in; other sinks would return "
                 "zeros for the skipped rows)")
    if args.check and args.resume_from:
        ap.error("--check verifies a full run; it cannot gate a "
                 "resumed (partial) one")
    if args.check and (args.stats_only or args.top_k):
        ap.error("--check compares full score panels; it needs the "
                 "array or --out output mode")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    from repro_torch.launch.obs_cli import finish_obs, start_tracing
    from repro_torch.scoring import BulkScorer, ScoreConfig

    start_tracing(args)
    plans = _build_plans(args)
    source = _build_source(args)
    sinks = _build_sinks(args, plans)
    cfg = ScoreConfig(chunk_rows=args.chunk, output=args.output,
                      prefetch_depth=args.prefetch_depth,
                      prequantize=not args.no_prequantize)
    scorer = BulkScorer(plans, cfg)

    eprint(f"[score] {len(plans)} plan(s) x {source.n_rows} rows x "
           f"{source.n_features} features on {scorer.device}; chunk="
           f"{scorer.resolve_chunk_rows(source.n_rows)} "
           f"({'auto' if not args.chunk else 'fixed'}), "
           f"output={args.output}, "
           f"prequantize={not args.no_prequantize}")
    result = scorer.score(source, sinks, resume_from=args.resume_from)
    m = result.metrics
    eprint(f"[score] {m['rows']} rows in {m['chunks']} chunks "
           f"({result.chunk_shapes} padded shapes, {m['compiles']} "
           f"first calls) -> {m['rows_per_s']:.0f} rows/s; quantize "
           f"{m['quantize_frac']:.0%} of busy time, pad overhead "
           f"{m['pad_overhead']:.1%}")
    print(json.dumps(m, default=float))
    finish_obs(args, {"scoring/bulk": m})
    for name, out in result.outputs.items():
        if isinstance(out, dict) and "mean" in out:      # StatsSink
            eprint(f"[score] {name}: mean={np.round(out['mean'], 4)} "
                   f"std={np.round(out['std'], 4)}")
        elif isinstance(out, dict):                      # TopKSink
            eprint(f"[score] {name}: top rows {out['indices'].tolist()}")
        elif isinstance(out, np.ndarray):
            eprint(f"[score] {name}: scores {out.shape} in memory")
        else:
            eprint(f"[score] {name}: wrote {out}")

    if args.check:
        if not _check(args, plans, source, result):
            eprint("[score] CHECK FAILED: bulk output diverges from the "
                   "plans' own entries")
            return 1
        eprint("[score] check OK: bulk == one-shot")
    return 0


if __name__ == "__main__":
    sys.exit(main())
