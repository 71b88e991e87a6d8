#!/usr/bin/env python3
"""What the port's tracer costs the benchmark's cells on the card, and
whether its clock agrees with `torch.profiler`'s there.

    python3 scripts/trace_probe.py [--cells covertype-apply,covertype-train]
        [--seconds 10] [--seed 2147495993] [--rounds 2]
        [--out chiprun_out/trace_probe.json]

For each cell of `BENCHMARK.json` named, one process sets the cell's
driver up once (`bench/benchlib`: the cell's model, data and warm-up, then
the collector frozen, as a benchmark run does) and runs its window
`--rounds` times in each of three modes, in turn: untraced, the tracer
alone, and the tracer under `torch.profiler` (CPU and CUDA activity, as a
`--trace 1` run profiles).  It prints, a mode a line, the window's time a
step (ms a tree or a call) and the cell's end-to-end number
(`train_step_ms` or `apply_rows_per_s`), so the tracer's cost is the
second mode against the first and a traced benchmark run's the third.
A traced mode's line also gives, for each span name, the spans recorded
and their host and device milliseconds a step.

Under the profiler, every live span the tracer recorded, placed on the
profiler's clock by `Tracer.epoch_unix_ns`, is matched to the profiler
range of its name that the tracer's bridge opened (the n-th span of a
name to the n-th range of it): the line gives the median, 99th
percentile and largest distance between their starts in microseconds, how
many lie over 1 ms, the spans matched, and any name whose spans and ranges
differ in number (`complete()` events have no range).  The last line is the
card's name and power limit as `nvidia-smi` reports them.  Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

MODES = ("off", "tracer", "tracer+profiler")


def clock_offsets(prof, tracer) -> dict:
    """Each live span's start against its bridged profiler range's."""
    from torch.autograd import DeviceType

    ranges: dict[str, list[int]] = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU and ev.is_user_annotation():
            ranges[ev.name()].append(ev.start_ns())
    spans: dict[str, list[float]] = collections.defaultdict(list)
    epoch = tracer.epoch_unix_ns
    for e in tracer.events():
        if e["ph"] == "X":
            spans[e["name"]].append(epoch + e["ts_us"] * 1e3)
    offsets, unmatched = [], {}
    for name, starts in spans.items():
        got = sorted(ranges.get(name, ()))
        if len(got) != len(starts):
            unmatched[name] = [len(starts), len(got)]
            continue
        offsets += [(r - s) / 1e3 for s, r in zip(sorted(starts), got)]
    size = sorted(abs(o) for o in offsets)
    if not size:
        return {"spans_matched": 0, "unmatched": unmatched}
    return {"spans_matched": len(size),
            "median_abs_us": statistics.median(size),
            "p99_abs_us": size[int(0.99 * (len(size) - 1))],
            "max_abs_us": size[-1],
            "over_1ms": sum(o > 1000 for o in size),
            "median_signed_us": statistics.median(offsets),
            "unmatched": unmatched}


def span_summary(tracer, steps: int) -> dict:
    """{name: [spans, host ms a step, device ms a step]} of the window's
    spans."""
    out: dict[str, list] = {}
    for e in tracer.events():
        if e["ph"] != "X":
            continue
        row = out.setdefault(e["name"], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += e["dur_us"] / 1e3 / steps
        row[2] += e["args"].get("device_ms", 0.0) / steps
    return out


def run_cell(name: str, seed: int, seconds: float, rounds: int) -> list:
    import torch
    from benchlib import harness, profile, spec
    from repro_torch.obs.trace import get_tracer

    cell = spec.cell(name, ROOT)
    driver, devs = harness.build(cell, seed, seconds, "cuda")
    t0 = time.perf_counter()
    driver.setup()
    torch.cuda.synchronize()
    harness.settle()
    setup_s = time.perf_counter() - t0
    tracer = get_tracer()
    lines = []
    for rnd in range(rounds):
        for mode in MODES:
            tracer.clear()
            prof = None
            if mode != "off":
                tracer.enable()
            if mode == "tracer+profiler":
                prof = profile.start()
            try:
                got = driver.window()
                torch.cuda.synchronize()
            finally:
                tracer.disable()
                if prof is not None:
                    prof.__exit__(None, None, None)
            facts = got["facts"]
            step_s = facts.get("step_s", facts.get("call_s"))
            line = {"cell": name, "round": rnd, "mode": mode,
                    "window_s": got["window_s"], "steps": got["attempted"],
                    "ms_a_step": step_s * 1e3, "e2e": got["e2e"],
                    "setup_s": setup_s, "events": len(tracer),
                    "dropped_events": tracer.dropped}
            if mode != "off":
                line["spans"] = span_summary(tracer, got["attempted"])
            if prof is not None:
                line["clock"] = clock_offsets(prof, tracer)
            print(json.dumps(line), flush=True)
            lines.append(line)
    driver.release()
    tracer.clear()
    torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="covertype-apply,covertype-train")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 12345)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    lines = []
    for name in args.cells.split(","):
        lines += run_cell(name, args.seed, args.seconds, args.rounds)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[:1]
    print(json.dumps({"card": card, "torch": torch.__version__}))
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"runs": lines, "card": card}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
