"""Train a GBDT on a streamed out-of-core source, then serve it.

The port's counterpart of `src/repro/launch/train_gbdt.py`, on the card
unless ``--device cpu``.  A `SyntheticSource` is streamed chunk by chunk
through `quantize_pool_chunked` (float rows exist one chunk at a time),
boosting runs the registered `histogram` op over the uint8 pool, and the
fitted ensemble goes through `Predictor.build` to score a pool quantized
again from the source, which must give the trainer's reported
training-time predictions exactly:

    python -m repro_torch.launch.train_gbdt --dataset covertype \\
        --scale 0.01 --repeat 4 --trees 20 --check

Per-tree resume:

    python -m repro_torch.launch.train_gbdt ... --ckpt-dir ck --ckpt-every 5
    python -m repro_torch.launch.train_gbdt ... --ckpt-dir ck --resume-from -1

`--check` exits non-zero unless serve parity is exact, boosting performed
zero binarize dispatches, the level histograms took at most `depth`
shapes (the port's counterpart of the JAX package's compiled-shape
contract), the streamed source exceeded one chunk, and the train loss
decreased.  Machine-readable metrics go to stdout, progress to stderr.
``--trace-out FILE`` writes a Chrome trace of the run (load it in
Perfetto), ``--metrics-out FILE`` the `training/<name>` metrics
(Prometheus text for a ``.prom`` file, JSON otherwise).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def eprint(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def parse_args(argv=None):
    from repro_torch.kernels import registry

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train_gbdt",
        description="train on a streamed source, close the serve loop")
    ap.add_argument("--dataset", default="covertype")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=None,
                    help="synthetic dataset seed")
    ap.add_argument("--repeat", type=int, default=4,
                    help="virtual-tile the base split this many times "
                         "(out-of-core row count at in-core cost)")
    ap.add_argument("--chunk", type=int, default=2048,
                    help="streaming chunk rows (0 = planner)")
    ap.add_argument("--trees", type=int, default=20)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--l2", type=float, default=3.0)
    ap.add_argument("--max-bins", type=int, default=64)
    ap.add_argument("--rsm", type=float, default=1.0)
    ap.add_argument("--ordered", action="store_true")
    ap.add_argument("--boost-seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", *registry.known_backends()])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the trainer and the plan run (the card "
                         "by default)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every k trees (0 = off)")
    ap.add_argument("--resume-from", type=int, default=None,
                    help="resume from checkpointed tree index "
                         "(-1 = latest)")
    ap.add_argument("--check", action="store_true")
    from repro_torch.launch.obs_cli import add_obs_flags
    add_obs_flags(ap)
    args = ap.parse_args(argv)
    if args.ckpt_every and not args.ckpt_dir:
        ap.error("--ckpt-every requires --ckpt-dir")
    if args.resume_from is not None and not args.ckpt_dir:
        ap.error("--resume-from requires --ckpt-dir")
    return ap, args


def check_failures(args, source, hist, parity: float) -> list[str]:
    """The five `--check` contracts; an empty list passes."""
    failures = []
    if parity != 0.0:
        failures.append(f"train->serve parity not exact: "
                        f"max|diff| = {parity}")
    dd = hist["dispatch_delta"]
    if dd.get("binarize", 0) != 0:
        failures.append(f"boosting dispatched binarize "
                        f"{dd['binarize']}x (expected 0)")
    if hist["hist_first_calls"] > args.depth:
        failures.append(
            f"the level histograms took {hist['hist_first_calls']} shapes "
            f"> depth {args.depth}: the shape contract is broken")
    if source.n_rows <= hist["chunk_rows"]:
        failures.append(
            f"source ({source.n_rows} rows) fits one chunk "
            f"({hist['chunk_rows']}): not an out-of-core run")
    tl = hist["train_loss"]
    if len(tl) >= 2 and not tl[-1] < tl[0]:
        failures.append(f"train loss did not decrease: "
                        f"{tl[0]} -> {tl[-1]}")
    return failures


def main(argv=None) -> int:
    ap, args = parse_args(argv)

    from repro_torch.core import boosting, predictor, quantize
    from repro_torch.core.losses import make_loss
    from repro_torch.launch.obs_cli import finish_obs, start_tracing
    from repro_torch.scoring import sources as sources_lib
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.gbdt import GBDTTrainer

    source = sources_lib.SyntheticSource(
        args.dataset, scale=args.scale, seed=args.seed, split="train",
        repeat=args.repeat)
    ds = source.dataset
    if ds.loss in ("pairlogit", "yetirank"):
        ap.error(f"{args.dataset} uses a grouped ranking loss; "
                 "train_gbdt streams rows without group structure")
    # row i of the source maps to base row i % base_rows
    y = np.tile(np.asarray(ds.y_train), args.repeat)[:source.n_rows]
    loss = make_loss(ds.loss, n_classes=ds.n_classes)

    params = boosting.BoostingParams(
        n_trees=args.trees, depth=args.depth, learning_rate=args.lr,
        l2_reg=args.l2, max_bins=args.max_bins, rsm=args.rsm,
        ordered=args.ordered, seed=args.boost_seed)
    trainer = GBDTTrainer(loss, params, backend=args.backend,
                          device=args.device, name=f"gbdt-{args.dataset}")
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    start_tracing(args)
    eprint(f"training {args.trees} trees (depth {args.depth}) on "
           f"{source.n_rows} streamed rows "
           f"({source.base_rows} base x {args.repeat}) on {trainer.device}")
    t0 = time.perf_counter()
    ens, hist = trainer.fit_source(
        source, y, chunk_rows=args.chunk, checkpoint=ckpt,
        checkpoint_every=args.ckpt_every, resume_from=args.resume_from)
    train_s = time.perf_counter() - t0

    # serve round trip: a fresh plan and a pool quantized again from the
    # source under the trained borders (which also exercises the schema
    # fingerprint guard)
    plan = predictor.Predictor.build(ens, strategy="staged", layout="soa",
                                     backend=args.backend,
                                     device=trainer.device)
    pool = quantize.quantize_pool_chunked(
        sources_lib.iter_chunks(source, hist["chunk_rows"]), ens.borders,
        backend=args.backend, device=trainer.device)
    t1 = time.perf_counter()
    served = plan.raw(pool).cpu().numpy()
    score_s = time.perf_counter() - t1
    parity = float(np.max(np.abs(served - hist["final_raw"])))

    out = {
        "dataset": args.dataset,
        "rows": source.n_rows,
        "base_rows": source.base_rows,
        "chunk_rows": hist["chunk_rows"],
        "n_chunks": hist["n_chunks"],
        "trees": args.trees,
        "depth": args.depth,
        "backend": args.backend,
        "train_s": train_s,
        "serve_score_s": score_s,
        "serve_rows_per_s": source.n_rows / max(score_s, 1e-9),
        "final_metric": hist["final_metric"],
        "serve_parity_max_abs": parity,
        "dispatch_delta": hist["dispatch_delta"],
        "metrics": hist["metrics"],
    }
    print(json.dumps(out, indent=2, default=float))
    finish_obs(args, {f"training/{trainer.metrics.name}": trainer.metrics})

    if args.check:
        failures = check_failures(args, source, hist, parity)
        if failures:
            eprint("CHECK FAILED:")
            for f in failures:
                eprint(f"  - {f}")
            return 1
        eprint(f"CHECK OK: exact serve parity over {source.n_rows} rows "
               f"({hist['n_chunks']} chunks), zero binarize dispatches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
