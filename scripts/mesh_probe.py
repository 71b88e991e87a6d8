#!/usr/bin/env python3
"""`Predictor.sharded` across the machine's cards.

Builds the kernels, then on `make_local_mesh(n)` (n = `--shards`, default
4, dealt round robin over the visible cards) and on the (n/2, 2)
hybrid mesh scores the Covertype test split (139,440 x 54) with a
numpy-seeded random model of the smoke's shape (`bulk_probe.model`: 1,000
trees, depth 8, 7 outputs) on the fused and the staged soa plans, and
prints one JSON object:

  * `checks`: row-sharded pool, float and ragged (139,437 rows) scores
    against the single-device plan, bit for bit; the tree-sharded and
    hybrid scores' largest difference from it as a share of
    `chip_smoke.sum_limit` (must be <= 1); the launches each card made
    (every card of the mesh must launch);
  * `rates`: rows/s of the single-device plan and of the mesh, pool and
    float routes, at the bulk shape and at the 1,024-row bucket (CUDA
    events on the first card around the call, median of `--reps`).

Run from the root of a checkout on a machine with Hopper cards (with
``CUDA_VISIBLE_DEVICES=0`` the four shards share one card):

    python3 scripts/mesh_probe.py [--shards 4] [--reps 5]

Any failed check exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT,
                    os.path.join(ROOT, "scripts")]
    import torch
    if not torch.cuda.is_available():
        sys.exit("mesh_probe: no CUDA device")
    from bulk_probe import model
    from chip_smoke import check, events_ms, sum_limit
    from repro_torch.core.predictor import Predictor
    from repro_torch.data.synthetic import covertype
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import make_local_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    n_cards = torch.cuda.device_count()
    n_shards = args.shards
    mesh = make_local_mesh(n_shards)
    hybrid = make_local_mesh(n_shards, model=2)
    x = covertype(scale=1.0, seed=0).x_test
    ens = model()
    n = len(x)
    ragged = n - 3

    per_card: dict[int, int] = {}
    launch = _build.launch

    def counting(name, device, *a):
        per_card[device.index] = per_card.get(device.index, 0) + 1
        return launch(name, device, *a)
    _build.launch = counting

    checks, rates = {}, {}
    for kind in ("fused", "staged"):
        plan = Predictor.build(ens, device="cuda", layout="soa",
                               strategy=kind)
        pool = plan.quantize(x)
        fn = plan.sharded(mesh, shard_axis="rows")
        want = plan.raw(pool)
        bins = ops.binarize_u8(torch.as_tensor(x, device=plan.device),
                               plan.lowered.borders)
        limit = sum_limit(ops.leaf_index(bins, plan.lowered.split_features,
                                         plan.lowered.split_bins),
                          plan.lowered.leaf_values, plan.ensemble.base_score)
        per_card.clear()
        for route, data, part in (("pool", pool, pool.slice_rows(0, ragged)),
                                  ("float", x, x[:ragged])):
            check(torch.equal(fn(data), want),
                  f"{kind} {route}: row-sharded scores differ")
            check(torch.equal(fn(part), want[:ragged]),
                  f"{kind} {route}: ragged row-sharded scores differ")
        torch.cuda.synchronize()
        check(len(per_card) == min(n_shards, n_cards),
              f"{kind}: launches by card {per_card}")
        shares = {}
        for axis, sharded in (("trees", plan.sharded(mesh,
                                                     shard_axis="trees")),
                              ("hybrid", plan.sharded(hybrid))):
            for route, data in (("pool", pool), ("float", x)):
                share = float(((sharded(data) - want).abs() / limit).max())
                check(share <= 1.0, f"{kind} {axis} {route}: {share} of "
                      "the limit")
                shares[f"{axis}_{route}"] = share
        checks[kind] = {"rows_exact": True, "launches_by_card":
                        dict(sorted(per_card.items())),
                        "err_over_limit": shares}
        for label, rows in (("bulk", n), ("bucket_1024", 1024)):
            p = pool.slice_rows(0, rows)
            xd = torch.as_tensor(x[:rows], device=plan.device)
            for route, data in (("pool", p), ("float", xd)):
                one = events_ms(lambda: plan.raw(data), args.reps)
                many = events_ms(lambda: fn(data), args.reps)
                rates[f"{kind}_{label}_{route}"] = {
                    "rows": rows, "single_ms": one, "sharded_ms": many,
                    "single_rows_per_s": rows / one * 1e3,
                    "sharded_rows_per_s": rows / many * 1e3}
    print(json.dumps({"cards": smi, "shards": n_shards,
                      "devices": [str(d) for d in mesh.device_list],
                      "build_s": build_s, "checks": checks,
                      "rates": rates}))


if __name__ == "__main__":
    main()
