#!/usr/bin/env python3
"""Training seconds a tree on the card, this checkout against an earlier
one, at the Covertype width of `chip_smoke.py` (325,360 rows, 54
features, 7 classes, MultiClass, depth 8, lr 0.5, 63 borders).

    python3 scripts/train_time_probe.py [--parent DIR] [--trees 100,1000]
    python3 scripts/train_time_probe.py --one SRC --trees 100,1000

Each fit runs in a process of its own (`--one SRC`: SRC the `src`
directory whose `repro_torch` it imports, kernels built from that
checkout), in the order parent, change, change, parent when `--parent
DIR` names an unpacked earlier checkout (e.g. `git archive HEAD~1 | tar
-x -C DIR`), so drift of the card's clocks shows as a difference between
the two runs of one version.  For each tree count it prints the fit's
wall seconds and seconds a tree (`boosting.fit` from the float matrix,
the first call of the process excluded by a 2-tree warm-up fit) and the
trainer's stage medians (`TrainingMetrics`: iteration, histogram, split
search and leaf update, CUDA events).  One JSON object a line; the last
line is the card's name and power limit as `nvidia-smi` reports them.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(src: str, trees: list[int]) -> None:
    """The fits of one checkout, in this process."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.core import boosting
    from repro_torch.core.losses import MultiClass
    from repro_torch.data.synthetic import covertype

    data = covertype(scale=1.0, seed=0)
    loss = MultiClass(n_classes=data.n_classes)

    def fit(n_trees):
        params = dataclasses.replace(data.params, n_trees=n_trees,
                                     max_bins=64, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, history = boosting.fit(data.x_train, data.y_train, params=params,
                                  device="cuda", loss=loss)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, history["metrics"]

    fit(2)
    for n in trees:
        secs, m = fit(n)
        print(json.dumps({"src": src, "trees": n, "seconds": secs,
                          "seconds_a_tree": secs / n,
                          **{k: m[k] for k in (
                              "iter_p50_ms", "hist_p50_ms", "split_p50_ms",
                              "leaf_p50_ms", "final_train_loss")}}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--one", default=None)
    ap.add_argument("--trees", default="100,1000")
    args = ap.parse_args()
    trees = [int(t) for t in args.trees.split(",")]
    if args.one:
        one(args.one, trees)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    change = os.path.join(ROOT, "src")
    order = [change]
    if args.parent:
        parent = os.path.join(os.path.abspath(args.parent), "src")
        order = [parent, change, change, parent]
    for src in order:
        proc = subprocess.run(
            [sys.executable, __file__, "--one", src, "--trees", args.trees],
            capture_output=True, text=True, timeout=1200,
            env={**os.environ, "PYTHONPATH": src})
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        sys.stdout.write(proc.stdout)
        sys.stdout.flush()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout else "unknown")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
