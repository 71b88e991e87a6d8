"""The rate sweep that fixes a serve cell's offered rate:

    python3 bench/sweep_serve.py --workload <cell> --rates 500,1000,... \
        --seconds <s> --limit-ms <p95 limit> [--seed <n>] [--out <file>]

Each rate takes `--repeats` open-loop windows, each on a server set up
afresh with its own seed, as a run of the cell sets one up (the cell's own
traffic otherwise), all in one process.  Each window prints one JSON line:
requests, latency p50 / p95 / p99 in ms, how late the generator ran, the
share not answered within the grace, rows a batch, and whether the backlog
grew (the median latency of the window's last fifth of requests more than
twice that of its first fifth and above half the limit).  The last line
names the highest rate whose every window's p95 met the limit with no
growing backlog and no request lost, and the rate four fifths of it: what
the cell's traffic file then fixes.  Rates run from the lowest up; the
sweep stops after two rates in a row miss.

Staged: no cell of `BENCHMARK.json` runs the serve mix yet; the sweep's
tables are in `PERF.md`, Open questions.
"""
import argparse
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--limit-ms", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from benchlib import harness, spec

    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    rows, best, misses = [], None, 0
    for rate in sorted(float(r) for r in args.rates.split(",")):
        if misses == 2:
            break
        ok = True
        for rep in range(args.repeats):
            driver, _ = harness.build(cell, args.seed + rep, args.seconds,
                                      "cuda", mix={"rate_per_s": rate})
            driver.setup()
            harness.settle()
            got = driver.window()
            driver.release()
            lat = got["facts"]["latency_ms"]
            fifth = max(1, len(lat) // 5)
            first, last = np.median(lat[:fifth]), np.median(lat[-fifth:])
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            f = got["facts"]
            row = {"rate_per_s": rate, "seed": args.seed + rep,
                   "requests": got["attempted"], "failed": got["failed"],
                   "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
                   "late_p95_ms": float(np.percentile(f["late_s"], 95)
                                        * 1e3),
                   "rows_per_batch": f["served_rows"] / max(f["batches"],
                                                            1),
                   "growing": bool(last > 2 * first
                                   and last > args.limit_ms / 2)}
            ok = ok and p95 <= args.limit_ms and not row["growing"] \
                and not got["failed"]
            rows.append(row)
            print(json.dumps(row), flush=True)
        if ok and (best is None or rate > best):
            best = rate
        misses = 0 if ok else misses + 1
    summary = {"workload": args.workload, "limit_ms": args.limit_ms,
               "highest_rate": best,
               "cell_rate": None if best is None else 0.8 * best,
               "device": torch.cuda.get_device_name(0)}
    print(json.dumps(summary), flush=True)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("".join(json.dumps(x) + "\n"
                                for x in rows + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
