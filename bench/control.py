"""Readings that the limits of `correct` are set from, for one cell, in one
process:

    python3 bench/control.py --workload <cell> --seconds <s> \
        --seeds 1,2,... --control-seeds 7,8,9 [--controls bf16,...] \
        [--out <file.jsonl>]

For each of `--seeds` a run of the program (set-up, a window of
`--seconds`, the check) gives the lower readings: the numbers the check
compares.  For each of `--control-seeds` each control of `--controls` (by
default every control of the configuration's stated precision,
`harness.CONTROLS`: the reference put in the program's place in a lower
precision) gives the upper ones.  One JSON line a run, then a summary
line: the largest program reading and the smallest control reading of each
number, over all controls and for each.  The benchmark's own runs never
run a control.
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
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchlib import harness, spec

    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    controls = [c for c in args.controls.split(",") if c] \
        or list(harness.CONTROLS[cell.config["dtype"]])
    lines, lower, upper, by_control = [], {}, {}, {}
    runs = [(int(s), None) for s in args.seeds.split(",") if s] + \
        [(int(s), c) for s in args.control_seeds.split(",") if s
         for c in controls]
    for seed, control in runs:
        r = harness.run_cell(cell, seed, args.seconds, False,
                             control=control)
        row = {"seed": seed, "control": control, "correct": r["correct"],
               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
               "checks": {k: v["value"] for k, v in r["checks"].items()}}
        for k, v in row["checks"].items():
            if control:
                upper[k] = min(upper.get(k, float("inf")), v)
                mine = by_control.setdefault(control, {})
                mine[k] = min(mine.get(k, float("inf")), v)
            else:
                lower[k] = max(lower.get(k, 0.0), v)
        lines.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "lower": lower, "upper": upper,
               "upper_by_control": by_control,
               "device": torch.cuda.get_device_name(0)}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
