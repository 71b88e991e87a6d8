#!/usr/bin/env python3
"""Time the three fused kernels' two routes over a range of row counts on
the card, and check each against the tree-order float32 sum bit for bit.

    python3 scripts/fused_route_sweep.py [--rows 16,1024,139440]
        [--layout soa,depth_major,bitpacked] [--pairs 1024,2048]
        [--threads 256] [--out build/sweep.json]

The model is numpy-seeded at the Covertype serving shape (1,000 trees of
depth 8, 7 outputs, 54 features, 63 borders) and, with `--knn`, also at
the kNN head's (1,000 trees of depth 4, 20 outputs, 533 features).  For
each layout (`--layout`: soa, whose kernel reads (T, D) split rows;
depth_major, whose kernel reads the same splits as (D, T) planes with
level weights 2^d; bitpacked, whose kernel reads them as the one group's
(D, T) planes with uint8 thresholds), each shape, each row count and
each spread setting (`--pairs`: the (row, tree) pairs a chunk,
`tuning.SPREAD_PAIRS`; `--threads`: a block's threads), it prints the
plan's route and both routes' median CUDA-event times with L2 flushed
(as `chip_smoke.py` times), the kernel's own device time from
`torch.profiler`, and the time a launch of 20 back to back: what
`kernels/tuning.py fused_plan` is set from (its SPREAD_MAX_ROWS,
SPREAD_MAX_ROWS_DM and SPREAD_MAX_ROWS_BP).  The layouts of one model
alternate row count by row count, so their times come from one stretch
of the card.  One JSON object a line; the last line is the card.  Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"covertype": dict(t=1000, d=8, c=7, f=54, b=63),
          "knn": dict(t=1000, d=4, c=20, f=533, b=63)}


def model(t, d, c, f, b, n, seed=0):
    """Numpy-seeded splits, leaves, borders and n rows of x (5% NaN)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    return dict(
        x=x, borders=np.sort(rng.normal(size=(b, f)), 0).astype(np.float32),
        sf=rng.integers(0, f, (t, d)).astype(np.int32),
        sb=rng.integers(1, b + 1, (t, d)).astype(np.int32),
        lv=(0.1 * rng.normal(size=(t, 1 << d, c))).astype(np.float32))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", default="1,16,64,256,1024,2048,4096,"
                        "8192,16384,32768,139440")
    parser.add_argument("--pairs", default="1024")
    parser.add_argument("--threads", default="512")
    parser.add_argument("--layout", default="soa",
                        help="comma-separated: soa, depth_major, "
                        "bitpacked")
    parser.add_argument("--knn", action="store_true")
    parser.add_argument("--reps", type=int, default=30)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("fused_route_sweep: needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import ref, tuning
    from repro_torch.kernels.fused_predict import (fused_predict,
                                                   fused_predict_bp,
                                                   fused_predict_dm)
    # the plan's `splits` of each layout's kernel
    splits = {"soa": "rows", "depth_major": "planes",
              "bitpacked": "bitpacked"}
    layouts = args.layout.split(",")
    if not set(layouts) <= set(splits):
        sys.exit(f"fused_route_sweep: --layout takes {', '.join(splits)}, "
                 f"not {args.layout}")

    def time_ms(fn, flush):
        fn()
        times = []
        for _ in range(args.reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def kernel_ms(fn, flush, reps=10):
        """Mean device time of the kernel a call launches, from
        torch.profiler (None if the profiler saw no device time)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "device_time_total", 0)
                    for e in prof.key_averages() if "fused" in e.key)
        return total / reps / 1e3 if total else None

    def loop_ms(fn, reps=20):
        """CUDA-event time of `reps` launches back to back, a launch (L2
        warm after the first)."""
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def tree_order_sum(idx, lv):
        acc = torch.zeros((idx.shape[0], lv.shape[2]), device=idx.device)
        for t in range(idx.shape[1]):
            acc += lv[t][idx[:, t].long()]
        return acc

    from repro_torch.kernels import _build
    _build.library()
    entry = ""          # the kernel the ptxas lines below belong to
    for line in _build.build_info.get("log", "").splitlines():
        if "Compiling" in line:
            entry = line
        if "fused" in entry and ("registers" in line or "Compiling" in line
                                 or "spill" in line):
            print(f"ptxas {line.strip()}")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = [int(r) for r in args.rows.split(",")]
    lines = []
    for shape in ("covertype", "knn") if args.knn else ("covertype",):
        dims = SHAPES[shape]
        arrays = {k: torch.as_tensor(v, device="cuda") for k, v in model(
            **dims, n=max(rows)).items()}
        x, borders, sf, sb, lv = (arrays[k] for k in
                                  ("x", "borders", "sf", "sb", "lv"))
        # depth_major's lowering of the same splits: (D, T) planes and
        # level weights 2^d (src/repro_torch/core/layout.py)
        sf_dm, sb_dm = sf.t().contiguous(), sb.t().contiguous()
        pow2 = (2.0 ** torch.arange(dims["d"], device="cuda")
                ).reshape(-1, 1).float()
        # bitpacked's: every tree at full depth, so one group of the same
        # planes in model order, thresholds narrowed to uint8
        sb_bp = sb_dm.to(torch.uint8)
        kernels = {
            "soa": lambda xn, r: fused_predict(xn, borders, sf, sb, lv,
                                               route=r),
            "depth_major": lambda xn, r: fused_predict_dm(
                xn, borders, sf_dm, sb_dm, pow2, lv, route=r),
            "bitpacked": lambda xn, r: fused_predict_bp(
                xn, borders, sf_dm, sb_bp, lv, route=r)}
        for pairs in (int(p) for p in args.pairs.split(",")):
            for threads in (int(t) for t in args.threads.split(",")):
                tuning.SPREAD_PAIRS, tuning.SPREAD_THREADS = pairs, threads
                for n in rows:
                    xn = x[:n]
                    exact = tree_order_sum(
                        ref.leaf_index(ref.binarize(xn, borders), sf, sb), lv)
                    for layout in layouts:
                        line = {"layout": layout, "shape": shape, "rows": n,
                                "pairs": pairs, "threads": threads}
                        plan = tuning.fused_plan(
                            n, dims["t"], dims["d"], dims["c"], dims["f"],
                            True, splits=splits[layout])
                        spread = tuning.fused_plan(
                            n, dims["t"], dims["d"], dims["c"], dims["f"],
                            True, "spread", splits=splits[layout])
                        line.update(plan=plan.route, spread_rows=spread.rows,
                                    spread_chunk=spread.trees_per_chunk,
                                    spread_blocks=spread.n_blocks,
                                    spread_smem=spread.smem_bytes)
                        for route in ("spread", "row"):
                            fn = (lambda k=kernels[layout], r=route:
                                  k(xn, r))
                            if not torch.equal(fn(), exact):
                                sys.exit(f"fused_route_sweep: {layout} "
                                         f"{route} at {n} rows is not the "
                                         "tree-order sum")
                            line[f"{route}_ms"] = time_ms(fn, flush)
                            line[f"{route}_kernel_ms"] = kernel_ms(fn, flush)
                            line[f"{route}_loop_ms"] = loop_ms(fn)
                        print(json.dumps(line), flush=True)
                        lines.append(line)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "lines": lines}, fh)
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
