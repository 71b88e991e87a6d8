#!/usr/bin/env python3
"""Time the distance-matrix kernel on the card beside `addmm` at the kNN
path's shapes, its product kernel at each depth of its ring of stages,
and check it against the plain version under the distance rule.

    python3 scripts/l2sq_matrix_sweep.py [--stages 2,3] [--rounds 3]
        [--out build/l2sq_sweep.json]

The shapes are `chip_smoke.py`'s: the test split of
`image_embeddings(scale=1.0, seed=4)` against its train split (2,841 x
2,808, K = 512), and the first 4,096 test queries of `scale=8` against
its 22,464 references (one `KNNFeaturizer.transform` chunk).  For each
shape, in rounds, it prints median CUDA-event times with L2 flushed
before each call: the whole wrapper (`ms`: split pass and product, on
the plan's ring), the split pass alone (`split_ms`), the wrapper's
device time in event windows opened behind a `torch.cuda._sleep` spacer
(`device_ms`), the product kernel alone on a precomputed split at each
ring depth of `--stages` (`product_ms_<d>_stages`), and `addmm` (TF32
off, norms precomputed, as the smoke's yardstick).  `kernels/tuning.py`
matrix_plan takes the deepest ring that fits.  The timing is
`chip_smoke.py`'s own `time_ms` and `device_ms`, so the numbers compare
with the smoke's.  One JSON object a line; the last line is the card.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import device_ms, time_ms  # noqa: E402  the smoke's timing


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--stages", default="2,3")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("l2sq_matrix_sweep: needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data.synthetic import image_embeddings
    from repro_torch.kernels import _build, l2dist, ref, tuning
    torch.backends.cuda.matmul.allow_tf32 = False
    depths = [int(d) for d in args.stages.split(",")]
    dev = torch.device("cuda", torch.cuda.current_device())
    small, bulk = image_embeddings(scale=1.0), image_embeddings(scale=8)
    shapes = {"test_split": (small.emb_test, small.emb_train),
              "bulk": (bulk.emb_test[:4096], bulk.emb_train)}
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    lines = []
    for name, (qa, qb) in shapes.items():
        a = torch.as_tensor(qa, device=dev)
        b = torch.as_tensor(qb, device=dev)
        (m, k), n = a.shape, b.shape[0]
        want = ref.l2sq_matrix(a, b).double()
        limit = l2dist.matrix_limit(a, b)
        a_sq, b_sq = (a * a).sum(1), (b * b).sum(1)

        def addmm():
            return torch.addmm(a_sq[:, None] + b_sq[None, :], a, b.T,
                               alpha=-2).clamp_min_(0)

        plan = tuning.matrix_plan(m, n, k)
        got = l2dist.l2sq_matrix(a, b)
        share = float(((got.double() - want).abs() / limit).max())
        del got
        split = l2dist.split_pass(a, b, plan.k_pad)
        out = torch.empty((m, n), device=dev)
        for rnd in range(args.rounds):
            row = {"shape": name, "m": m, "n": n, "k": k, "round": rnd,
                   "stages": plan.stages, "grid": plan.grid,
                   "err_over_limit": share,
                   "ms": time_ms(lambda: l2dist.l2sq_matrix(a, b),
                                 args.reps, flush),
                   "split_ms": time_ms(lambda: l2dist.split_pass(
                       a, b, plan.k_pad), args.reps, flush),
                   "device_ms": device_ms(lambda: l2dist.l2sq_matrix(a, b),
                                          flush, args.reps, key="l2sq")[0]}
            for depth in depths:
                def product(depth=depth):
                    _build.launch("repro_l2sq_matrix", dev, *split, out, m,
                                  n, plan.k_pad, depth,
                                  tuning.matrix_smem_bytes(depth))

                row[f"product_ms_{depth}_stages"] = time_ms(
                    product, args.reps, flush)
            row["addmm_ms"] = time_ms(addmm, args.reps, flush)
            print(json.dumps(row), flush=True)
            lines.append(row)
        del a, b, want, limit, split, out
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": lines, "card": card}, f, indent=1)
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
